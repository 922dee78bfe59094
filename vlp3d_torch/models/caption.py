"""Transformer caption decoder (the Scan2Cap head) and the masked-LM path.

Counterpart of ``vlp3d/models/caption.py`` (the reference's
transformer_captioner.py:301-627). The reference's annotated-transformer
EncoderDecoder under ``use_transformer_encoder=False`` and
``early_guide=True`` is a decoder-only stack: each layer skips its
cross-attention (transformer_captioner.py:249-254) and the proposal
conditions the caption through a prepended object-indicator token.

Module and parameter names are the reference's
(``tgt_embed.0.lut``, ``tgt_embed.1.pe``, ``decoder.layers.{i}.self_attn
.linears.{0..3}``, ``sublayer.{0,2}.norm.a_2/b_2``, ``feed_forward.w_1/w_2``,
``decoder.norm``, ``generator.proj``), so the reference's state dict loads.
Its dead early-guide keys (``src_attn``, ``sublayer.1``, DEAD_KEYS) have
no module here: JointNet's loader drops them.

The JAX module's arithmetic is kept: masked scores are -1e9, not -inf;
embeddings are scaled by sqrt(d_model); :meth:`CaptionDecoder.embed_row`
adds PE row ``i``; greedy decode keeps taking the argmax past SEP (the
string is cut at SEP later); beam search ranks by cumulative log-prob and
breaks ties in its top-k by the lowest flat index, as ``lax.top_k`` does.
Decoding runs under no gradient.

Defaults: 6 layers, 8 heads, d_model 128, d_ff 512, dropout 0.1, vocab
30522 (transformer_captioner.py:303, jointnet.py:104).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.geometry.nn_distance import nn_distance
from vlp3d_torch.models.layers import Dropout, RefLayerNorm

PAD_ID = 0
CLS_ID = 101
SEP_ID = 102
MASK_ID = 103
NEG = -1e9  # masked attention scores and excluded beam candidates
PE_ROWS = 5000  # the reference's PositionalEncoding max_len
# the reference's dead early-guide keys of a decoder layer
DEAD_KEYS = (".src_attn.", ".sublayer.1.")


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """(max_len, d_model) float32 sin/cos table
    (transformer_captioner.py:151-163)."""
    pe = np.zeros((max_len, d_model), np.float32)
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                 * np.float32(-(math.log(10000.0) / d_model)))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class DecoderSelfAttention(nn.Module):
    """q/k/v/o projections (``linears.0..3``) and masked softmax attention,
    dropout on the attention probabilities."""

    def __init__(self, d_model: int, heads: int, dropout: float, device):
        super().__init__()
        self.heads = heads
        self.linears = nn.ModuleList(
            nn.Linear(d_model, d_model, device=device) for _ in range(4))
        self.dropout = Dropout(dropout)

    def _heads(self, x: torch.Tensor, proj: nn.Linear) -> torch.Tensor:
        b, t, d = x.shape
        return proj(x).view(b, t, self.heads, d // self.heads).transpose(1, 2)

    def _attend(self, q, k, v, keep) -> torch.Tensor:
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
        att = torch.where(keep, att, NEG)
        att = self.dropout(torch.softmax(att, dim=-1))
        out = torch.matmul(att, v)  # (b, h, t, dk)
        b, h, t, dk = out.shape
        return self.linears[3](out.transpose(1, 2).reshape(b, t, h * dk))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x (b, t, d); mask bool, broadcastable to (b, heads, t, t)."""
        q, k, v = (self._heads(x, p) for p in self.linears[:3])
        return self._attend(q, k, v, mask)

    def step(self, x_new, k_cache, v_cache, pos: int, keep) -> torch.Tensor:
        """One cached decode row: x_new (N, 1, d); k_cache / v_cache (N,
        heads, T, dk), rows < pos filled, row ``pos`` written here in
        place; keep (N, T) bool, the attendable cache rows. Returns (N, 1,
        d)."""
        q = self._heads(x_new, self.linears[0])
        k_cache[:, :, pos] = self._heads(x_new, self.linears[1])[:, :, 0]
        v_cache[:, :, pos] = self._heads(x_new, self.linears[2])[:, :, 0]
        return self._attend(q, k_cache, v_cache, keep[:, None, None, :])


class SublayerConnection(nn.Module):
    """The pre-LN residual's norm and dropout (transformer_captioner.py
    :132-145)."""

    def __init__(self, d_model: int, dropout: float, device):
        super().__init__()
        self.norm = RefLayerNorm(d_model, device=device)
        self.dropout = Dropout(dropout)


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int, d_ff: int, dropout: float, device):
        super().__init__()
        self.w_1 = nn.Linear(d_model, d_ff, device=device)
        self.w_2 = nn.Linear(d_ff, d_model, device=device)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(F.relu(self.w_1(x))))


class CaptionDecoderLayer(nn.Module):
    """Pre-LN: x + drop(attn(LN(x))); x + drop(ffn(LN(x))). Under
    early_guide the reference's cross-attention sublayer (``sublayer.1``,
    ``src_attn``) never runs and has no module here."""

    def __init__(self, d_model: int, d_ff: int, heads: int, dropout: float,
                 device):
        super().__init__()
        self.self_attn = DecoderSelfAttention(d_model, heads, dropout, device)
        self.feed_forward = PositionwiseFeedForward(d_model, d_ff, dropout,
                                                    device)
        self.sublayer = nn.ModuleDict({
            "0": SublayerConnection(d_model, dropout, device),
            "2": SublayerConnection(d_model, dropout, device)})

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        attn, ffn = self.sublayer["0"], self.sublayer["2"]
        x = x + attn.dropout(self.self_attn(attn.norm(x), mask))
        return x + ffn.dropout(self.feed_forward(ffn.norm(x)))

    def step(self, x_new, k_cache, v_cache, pos: int, keep) -> torch.Tensor:
        """The cached single-row layer (evaluation only)."""
        attn, ffn = self.sublayer["0"], self.sublayer["2"]
        x = x_new + self.self_attn.step(attn.norm(x_new), k_cache, v_cache,
                                        pos, keep)
        return x + self.feed_forward(ffn.norm(x))


class Embeddings(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, device):
        super().__init__()
        self.lut = nn.Embedding(vocab_size, d_model, device=device)


class PositionalEncoding(nn.Module):
    """The reference's (1, 5000, d_model) ``pe`` buffer and the dropout
    after the position is added."""

    def __init__(self, d_model: int, dropout: float, device):
        super().__init__()
        self.register_buffer("pe", torch.from_numpy(
            sinusoidal_positions(PE_ROWS, d_model)[None]).to(device))
        self.dropout = Dropout(dropout)


class Decoder(nn.Module):
    def __init__(self, n_layers, d_model, d_ff, heads, dropout, device):
        super().__init__()
        self.layers = nn.ModuleList(
            CaptionDecoderLayer(d_model, d_ff, heads, dropout, device)
            for _ in range(n_layers))
        self.norm = RefLayerNorm(d_model, device=device)


class Generator(nn.Module):
    def __init__(self, d_model: int, vocab_size: int, device):
        super().__init__()
        self.proj = nn.Linear(d_model, vocab_size, device=device)


class CaptionDecoder(nn.Module):
    """Token embedding + positions, N decoder layers, the final
    RefLayerNorm and the vocabulary projection (the reference's
    TransformerDecoderModel; ``CaptionDecoder`` in the JAX package)."""

    def __init__(self, vocab_size: int = 30522, n_layers: int = 6,
                 d_model: int = 128, d_ff: int = 512, heads: int = 8,
                 dropout: float = 0.1, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.vocab_size, self.n_layers = vocab_size, n_layers
        self.d_model, self.heads = d_model, heads
        self.tgt_embed = nn.ModuleList([
            Embeddings(vocab_size, d_model, device),
            PositionalEncoding(d_model, dropout, device)])
        self.decoder = Decoder(n_layers, d_model, d_ff, heads, dropout,
                               device)
        self.generator = Generator(d_model, vocab_size, device)

    def _lookup(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tgt_embed[0].lut(tokens.long()) * math.sqrt(self.d_model)

    def embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(N, T) ids -> (N, T, d): scaled embedding + PE rows 0..T-1,
        then the dropout."""
        pos = self.tgt_embed[1]
        return pos.dropout(self._lookup(tokens) + pos.pe[:, :tokens.shape[1]])

    def decode(self, obj_token, tokens, mask) -> torch.Tensor:
        """obj_token (N, 1, d); tokens (N, T); mask broadcastable to (N,
        heads, T+1, T+1) -> hidden states (N, T+1, d)."""
        x = torch.cat([obj_token, self.embed_tokens(tokens)], dim=1)
        for layer in self.decoder.layers:
            x = layer(x, mask)
        return self.decoder.norm(x)

    def forward(self, obj_token, tokens, mask) -> torch.Tensor:
        """Log-probabilities (N, T+1, vocab) of the teacher-forced
        sequence."""
        h = self.decode(obj_token, tokens, mask)
        return torch.log_softmax(self.generator.proj(h), dim=-1)

    def decode_step(self, obj_token, ys, i: int) -> torch.Tensor:
        """One uncached greedy step: the logits (N, vocab) of the token
        after position ``i`` of the (N, T) buffer ``ys`` (row i + 1; the
        object token is row 0)."""
        h = self.decode(obj_token, ys, causal_caption_mask(ys))
        return self.generator.proj(h[:, i + 1])

    def embed_row(self, tokens: torch.Tensor, i: int) -> torch.Tensor:
        """(N, 1) ids at sequence position ``i`` -> (N, 1, d): PE row i, no
        dropout (embed_tokens' row i at evaluation)."""
        return self._lookup(tokens) + self.tgt_embed[1].pe[:, i:i + 1]

    def new_caches(self, n: int, t: int, like: torch.Tensor):
        """Per-layer zero K and V caches (N, heads, T, d_k)."""
        shape = (n, self.heads, t, self.d_model // self.heads)
        return ([like.new_zeros(shape) for _ in range(self.n_layers)],
                [like.new_zeros(shape) for _ in range(self.n_layers)])

    def decode_step_kv(self, x_new, pos: int, keep, k_caches, v_caches):
        """KV-cached decode of one row: x_new (N, 1, d) (the object token
        at pos 0, an :meth:`embed_row` after); keep (N, T) attendable
        cache rows; the per-layer caches get row ``pos`` in place. Returns
        the logits (N, vocab) of the row :meth:`decode_step` computes,
        without rerunning rows < pos."""
        x = x_new
        for layer, kc, vc in zip(self.decoder.layers, k_caches, v_caches):
            x = layer.step(x, kc, vc, pos, keep)
        return self.generator.proj(self.decoder.norm(x)[:, 0])


class CaptionHead(nn.Module):
    """The reference's captioner shell, whose decoder is ``model``
    (state-dict keys ``caption.model.*`` / ``mlm.model.*``)."""

    def __init__(self, vocab_size: int, *, device=None):
        super().__init__()
        self.model = CaptionDecoder(vocab_size, device=device)


def causal_caption_mask(seq: torch.Tensor) -> torch.Tensor:
    """(N, T) ids -> (N, 1, T+1, T+1) bool: the object token (row 0)
    always attendable, pad tokens masked, causal
    (_prepare_feature, transformer_captioner.py:371-384)."""
    keep = _keep_rows(seq)
    t = keep.shape[1]
    causal = torch.ones(t, t, dtype=torch.bool, device=seq.device).tril()
    return keep[:, None, None, :] & causal


def padding_caption_mask(seq: torch.Tensor) -> torch.Tensor:
    """The non-causal mask of the MLM path (captioning=False, :382-383):
    (N, 1, 1, T+1)."""
    return _keep_rows(seq)[:, None, None, :]


def _keep_rows(seq: torch.Tensor) -> torch.Tensor:
    ones = torch.ones(seq.shape[0], 1, dtype=torch.bool, device=seq.device)
    return torch.cat([ones, seq > 0], dim=1)


def mask_caption_tokens(input_ids: torch.Tensor, vocab_size: int,
                        mask_ratio: float = 0.1, *,
                        generator: torch.Generator | None = None):
    """BERT-style 80/10/10 masking of the tokens that are neither PAD nor
    CLS (transformer_captioner.py:602-626): each is chosen with
    probability ``mask_ratio``; a chosen token becomes MASK with
    probability 0.8, else a uniform random id with probability 0.5, else
    stays. Draws come from ``generator`` (on the ids' device; the global
    generator when None). Returns (masked_ids, chosen (bool))."""
    shape, dev = input_ids.shape, input_ids.device

    def bernoulli(p):
        return torch.rand(shape, generator=generator, device=dev) < p

    masked = (bernoulli(mask_ratio) & (input_ids != PAD_ID)
              & (input_ids != CLS_ID))
    replace = bernoulli(0.8) & masked
    randomize = bernoulli(0.5) & masked & ~replace
    random_words = torch.randint(0, vocab_size, shape, generator=generator,
                                 device=dev, dtype=input_ids.dtype)
    out = torch.where(replace, MASK_ID, input_ids)
    return torch.where(randomize, random_words, out), masked


def nearest_proposal_token(agg_features, agg_xyz, ref_center):
    """The object-indicator token of each sentence: the feature of the
    proposal whose aggregation centre is nearest the GT reference centre
    (transformer_captioner.py:496-508), lowest index on ties.

    agg_features (B, K, C); agg_xyz (B, K, 3); ref_center (B, L, 3) ->
    (obj_token (B*L, 1, C), idx (B*L,), squared distance (B*L,))."""
    b, _, c = agg_features.shape
    _, _, dist2, idx2 = nn_distance(agg_xyz, ref_center)  # (B, L) over K
    idx = idx2.long()
    obj = torch.gather(agg_features, 1, idx[..., None].expand(-1, -1, c))
    return obj.reshape(-1, 1, c), idx.reshape(-1), dist2.reshape(-1)


def _start(n: int, t: int, start_id: int, device) -> torch.Tensor:
    ys = torch.full((n, t), PAD_ID, dtype=torch.long, device=device)
    ys[:, 0] = start_id
    return ys


def _keep(ys: torch.Tensor, cols: torch.Tensor, i: int) -> torch.Tensor:
    """Attendable cache rows at step i (cache row i + 1): the object token,
    and token rows <= i + 1 that are not PAD (causal_caption_mask's
    semantics)."""
    return _keep_rows(ys)[:, :ys.shape[1]] & (cols <= i + 1)


@torch.no_grad()
def greedy_decode(decoder: CaptionDecoder, obj_token: torch.Tensor,
                  max_len: int, start_id: int = CLS_ID) -> torch.Tensor:
    """KV-cached greedy decode: ``max_len + 1`` steps, each running one new
    row through the layers against per-layer K/V caches.

    obj_token (N, 1, d), the proposal's feature -> (N, max_len + 2) ids
    starting with CLS (forward_eval's contract,
    transformer_captioner.py:575-600). The same arithmetic as
    :func:`greedy_decode_uncached` but for the order of summation, so two
    near-tie argmaxes may differ."""
    n = obj_token.shape[0]
    t = max_len + 2  # CLS + max_len + 1 generated tokens
    kc, vc = decoder.new_caches(n, t, obj_token)
    cols = torch.arange(t, device=obj_token.device)[None, :]
    # cache row 0: the object token (its logits are never read)
    decoder.decode_step_kv(obj_token, 0, (cols == 0).expand(n, t), kc, vc)
    ys = _start(n, t, start_id, obj_token.device)
    for i in range(max_len + 1):
        x = decoder.embed_row(ys[:, i:i + 1], i)
        logits = decoder.decode_step_kv(x, i + 1, _keep(ys, cols, i), kc, vc)
        ys[:, i + 1] = torch.argmax(logits, dim=-1)
    return ys


@torch.no_grad()
def greedy_decode_uncached(decoder: CaptionDecoder, obj_token: torch.Tensor,
                           max_len: int,
                           start_id: int = CLS_ID) -> torch.Tensor:
    """The reference-shaped greedy decode (the whole buffer re-decoded each
    step, no cache; forward_eval's loop, transformer_captioner.py:581-594):
    the oracle of :func:`greedy_decode`."""
    n = obj_token.shape[0]
    ys = _start(n, max_len + 2, start_id, obj_token.device)
    for i in range(max_len + 1):
        ys[:, i + 1] = torch.argmax(decoder.decode_step(obj_token, ys, i),
                                    dim=-1)
    return ys


def top_k_first(x: torch.Tensor, k: int):
    """The k largest entries of each row of x (R, M), in descending order,
    ties to the lowest index (``lax.top_k``'s order; ``torch.topk``
    promises none on ties): k passes of argmax, which returns the first
    maximal index. Returns (values (R, k), indices (R, k))."""
    x = x.clone()
    vals, idxs = [], []
    for _ in range(k):
        idx = torch.argmax(x, dim=1, keepdim=True)
        vals.append(torch.gather(x, 1, idx))
        idxs.append(idx)
        x.scatter_(1, idx, -math.inf)
    return torch.cat(vals, dim=1), torch.cat(idxs, dim=1)


@torch.no_grad()
def beam_decode(decoder: CaptionDecoder, obj_token: torch.Tensor,
                max_len: int, num_beams: int, *, eos_id: int = SEP_ID,
                length_penalty: float = 1.0, min_len: int = 0,
                start_id: int = CLS_ID):
    """Fixed-shape beam search over the cached decoder (``beam_decode`` of
    the JAX package):

      * the search ranks by cumulative log-prob; each item returns the
        hypothesis with the largest score / gen_len ** length_penalty,
        gen_len counting generated tokens, EOS included;
      * a beam that emits ``eos_id`` freezes: it competes with its score
        while it continues as PAD at zero cost;
      * EOS is excluded before ``min_len`` generated tokens;
      * the K/V caches are reordered by parent each step;
      * at ``num_beams`` 1 it is :func:`greedy_decode` up to and including
        the first EOS (greedy then goes on decoding, the beam writes PAD).

    Returns (ys (N, max_len + 2) starting with CLS, the winner's
    normalised score (N,))."""
    n, nb = obj_token.shape[0], num_beams
    t, rows, vocab = max_len + 2, obj_token.shape[0] * num_beams, \
        decoder.vocab_size
    dev = obj_token.device
    kc, vc = decoder.new_caches(n, t, obj_token)
    cols = torch.arange(t, device=dev)[None, :]
    # the object-token row once at N rows, then tiled to N * nb
    decoder.decode_step_kv(obj_token, 0, (cols == 0).expand(n, t), kc, vc)
    kc = [c.repeat_interleave(nb, dim=0) for c in kc]
    vc = [c.repeat_interleave(nb, dim=0) for c in vc]
    ys = _start(rows, t, start_id, dev)
    # beams of an item start equal: only beam 0 is live at step 0, so the
    # first top-k picks nb distinct tokens
    score = torch.where(torch.arange(nb, device=dev) == 0, 0.0, NEG)
    score = score.expand(n, nb).contiguous()
    done = torch.zeros(n, nb, dtype=torch.bool, device=dev)
    glen = torch.zeros(n, nb, dtype=torch.long, device=dev)
    pad_row = torch.full((vocab,), NEG, device=dev)
    pad_row[PAD_ID] = 0.0
    base = torch.arange(n, device=dev)[:, None] * nb
    for i in range(max_len + 1):
        x = decoder.embed_row(ys[:, i:i + 1], i)
        logits = decoder.decode_step_kv(x, i + 1, _keep(ys, cols, i), kc, vc)
        logp = torch.log_softmax(logits.float(), dim=-1)
        # EOS gated before min_len generated tokens (this step generates
        # token glen + 1 of a live beam)
        eos_ok = glen.reshape(rows) + 1 >= min_len
        logp[:, eos_id] = torch.where(eos_ok, logp[:, eos_id], NEG)
        logp = torch.where(done.reshape(rows, 1), pad_row, logp)
        cand = score[:, :, None] + logp.view(n, nb, vocab)
        score, flat = top_k_first(cand.view(n, nb * vocab), nb)
        parent, token = flat // vocab, flat % vocab
        src = (base + parent).reshape(rows)
        # rows > i + 1 of every cache are still zero: reorder the rest
        ys = ys[src]
        for c in kc + vc:
            c[:, :, :i + 2] = c[src, :, :i + 2]
        done_p = torch.gather(done, 1, parent)
        glen_p = torch.gather(glen, 1, parent)
        ys[:, i + 1] = torch.where(done_p, PAD_ID, token).reshape(rows)
        glen = torch.where(done_p, glen_p, glen_p + 1)
        done = done_p | (~done_p & (token == eos_id))
    norm = score / glen.clamp(min=1).float() ** length_penalty
    best = torch.argmax(norm, dim=1)
    ys = ys.view(n, nb, t)[torch.arange(n, device=dev), best]
    return ys, norm.gather(1, best[:, None])[:, 0]
