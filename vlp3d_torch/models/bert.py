"""BERT text encoder (text mode) + language module, and the BERT pieces
of the dormant heads.

Counterpart of ``BertConfig``, ``BertEmbeddings``, ``BertLayer``,
``BertTextEncoder`` (text mode: layers [0, fusion_layer)) and
``LangModule`` in ``vlp3d/models/bert.py``, and of its
``BertFusionLayer``, ``BertMLMHead`` (the xbert captioner's,
:mod:`vlp3d_torch.models.caption_xbert`), ``LangCrossMLM`` and
``cross_mlm_loss``. The encoder is frozen in the
reference: the port runs it under no gradient and its parameters never
require one, but in training its dropout still draws (embeddings,
attention probabilities, both sublayer outputs), as the JAX module's
does.
Parameter names follow the vendored xbert layout the reference state dict
carries (``text_encoder.bert.encoder.layer.0.attention.self.query``).
LayerNorm eps is 1e-12; the attention mask is ADDED as
(1 - mask) * -10000; GELU is the exact erf form. DistilBERT
(:func:`distilbert_config`, ``use_distil``) is the same stack with 6
layers and no token-type table. :func:`load_hf_bert` puts a HF
bert-base-uncased checkpoint (:func:`read_hf_state_dict`) into the text
encoder, the counterpart of ``load_hf_bert_params``.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.attention import MultiHeadAttention, PredictionHead
from vlp3d_torch.models.caption import mask_caption_tokens
from vlp3d_torch.models.layers import Dropout


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    fusion_layer: int = 6  # text mode runs layers [0, fusion_layer)


def distilbert_config() -> BertConfig:
    """DistilBERT-base-uncased: 6 layers, all run in text mode (the
    reference's distil path calls the whole distilbert forward,
    lang_bert_module.py:99-101), and no token-type embeddings
    (type_vocab_size 0)."""
    return BertConfig(num_hidden_layers=6, fusion_layer=6, type_vocab_size=0)


class BertEmbeddings(nn.Module):
    def __init__(self, c: BertConfig, device):
        super().__init__()
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
                                            device=device)
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size, device=device)
        self.token_type_embeddings = nn.Embedding(
            c.type_vocab_size, c.hidden_size,
            device=device) if c.type_vocab_size else None
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      device=device)
        self.register_buffer(
            "position_ids",
            torch.arange(c.max_position_embeddings, device=device)[None, :])
        self.dropout = Dropout(c.hidden_dropout)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        seq = input_ids.shape[-1]
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(self.position_ids[:, :seq]))
        if self.token_type_embeddings is not None:
            x = x + self.token_type_embeddings(torch.zeros_like(input_ids))
        return self.dropout(self.LayerNorm(x))


class _SelfAttention(nn.Module):
    def __init__(self, c: BertConfig, device):
        super().__init__()
        self.query = nn.Linear(c.hidden_size, c.hidden_size, device=device)
        self.key = nn.Linear(c.hidden_size, c.hidden_size, device=device)
        self.value = nn.Linear(c.hidden_size, c.hidden_size, device=device)


class _DenseLN(nn.Module):
    """``dense`` + ``LayerNorm`` pair (attention.output / output)."""

    def __init__(self, cin: int, c: BertConfig, device):
        super().__init__()
        self.dense = nn.Linear(cin, c.hidden_size, device=device)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      device=device)
        self.dropout = Dropout(c.hidden_dropout)

    def forward(self, x: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dropout(self.dense(x)))


class _Attention(nn.Module):
    """One attention sublayer in the xbert layout: ``self.{query,key,
    value}``, the probabilities' dropout, ``output.{dense,LayerNorm}``
    with the residual."""

    def __init__(self, c: BertConfig, device):
        super().__init__()
        self.self = _SelfAttention(c, device)
        self.dropout = Dropout(c.attention_dropout)
        self.output = _DenseLN(c.hidden_size, c, device)


class BertLayer(nn.Module):
    """Self-attention, then the feed-forward. ``causal`` adds the
    decoder's -10000 above the diagonal (BertLMHeadModel's self-attention)
    on top of the padding mask."""

    def __init__(self, c: BertConfig, *, causal: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.causal = causal
        self.heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.attention = _Attention(c, device)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(c.hidden_size,
                                            c.intermediate_size,
                                            device=device)
        self.output = _DenseLN(c.intermediate_size, c, device)

    def attend(self, sub: _Attention, x: torch.Tensor, kv: torch.Tensor,
               add_mask: torch.Tensor | None,
               causal: bool = False) -> torch.Tensor:
        """``sub``'s attention of the queries ``x`` (B, S, H) over ``kv``
        (B, T, H) with the additive mask ``add_mask`` (broadcast to (B,
        heads, S, T)) and, with ``causal``, the causal term; its output
        projection and residual LayerNorm."""
        b, s, _ = x.shape
        t = kv.shape[1]
        sa = sub.self
        q, k, v = sa.query(x), sa.key(kv), sa.value(kv)
        # the heads this rank holds: all of them, or its whole heads under
        # tensor parallel (vlp3d_torch.parallel.tensor_parallel)
        dk = self.head_dim
        h = q.shape[-1] // dk
        q = q.reshape(b, s, h, dk).transpose(1, 2)
        k = k.reshape(b, t, h, dk).transpose(1, 2)
        v = v.reshape(b, t, h, dk).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
        if add_mask is not None:
            att = att + add_mask
        if causal:
            tri = torch.ones(s, s, device=x.device).tril()
            att = att + (1.0 - tri) * -10000.0
        att = sub.dropout(torch.softmax(att, dim=-1))
        ctx = torch.matmul(att, v).transpose(1, 2).reshape(b, s, h * dk)
        return sub.output(ctx, x)

    def feed_forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.gelu(self.intermediate.dense(x))  # exact erf GELU
        return self.output(y, x)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor):
        """x (B, S, H); attention_mask (B, S) float, 1 = attend."""
        x = self.attend(self.attention, x, x, extended_mask(attention_mask),
                        self.causal)
        return self.feed_forward(x)


def extended_mask(mask: torch.Tensor) -> torch.Tensor:
    """A (B, T) 1 / 0 mask as the additive (B, 1, 1, T) term,
    (1 - mask) * -10000."""
    return (1.0 - mask[:, None, None, :]) * -10000.0


class BertFusionLayer(BertLayer):
    """The ALBEF-style fusion layer (``BertFusionLayer`` in
    ``vlp3d/models/bert.py``, xbert.py:458-516): self-attention, then
    cross-attention to the encoder states (``crossattention``, xbert's
    layout, its mask -10000 where ``encoder_mask`` is 0), then the
    feed-forward on the cross-attention's output, each with its own
    residual LayerNorm. ``causal`` makes it a BertLMHeadModel decoder
    layer."""

    def __init__(self, c: BertConfig, *, causal: bool = False, device=None):
        device = resolve_device(device)
        super().__init__(c, causal=causal, device=device)
        self.crossattention = _Attention(c, device)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor,
                encoder_states: torch.Tensor,
                encoder_mask: torch.Tensor | None = None):
        x = self.attend(self.attention, x, x, extended_mask(attention_mask),
                        self.causal)
        x = self.attend(self.crossattention, x, encoder_states,
                        None if encoder_mask is None
                        else extended_mask(encoder_mask.float()))
        return self.feed_forward(x)


class BertTextEncoder(nn.Module):
    """Embeddings + encoder layers [0, fusion_layer) (xbert.py text mode)."""

    def __init__(self, config: BertConfig = BertConfig(), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.bert = nn.Module()
        self.bert.embeddings = BertEmbeddings(config, device)
        self.bert.encoder = nn.Module()
        self.bert.encoder.layer = nn.ModuleList(
            BertLayer(config, device=device)
            for _ in range(config.fusion_layer))

    def forward(self, input_ids, attention_mask):
        mask = attention_mask.float()
        x = self.bert.embeddings(input_ids)
        for layer in self.bert.encoder.layer:
            x = layer(x, mask)
        return x


class LangModule(nn.Module):
    """BERT text mode -> 768->128 projection, CLS embedding, lang classifier
    (lang_bert_module.py:98-140); without ``use_lang_classifier`` no
    ``lang_cls`` and no ``lang_scores``."""

    def __init__(self, num_class: int = 18, lang_hidden_size: int = 128,
                 bert_config: BertConfig = BertConfig(), *,
                 use_lang_classifier: bool = True, device=None):
        super().__init__()
        device = resolve_device(device)
        self.text_encoder = BertTextEncoder(bert_config, device=device)
        self.text_encoder.requires_grad_(False)  # frozen in the reference
        self.proj = nn.Linear(bert_config.hidden_size, lang_hidden_size,
                              device=device)
        self.lang_cls = nn.Sequential(
            nn.Linear(lang_hidden_size, num_class, device=device),
            Dropout(0.5)) if use_lang_classifier else None

    def forward(self, input_ids: torch.Tensor,
                attention_mask: torch.Tensor) -> dict:
        """input_ids, attention_mask (B, L, T) -> lang_fea (B*L, T, 128), ..."""
        b, l, t = input_ids.shape
        ids = input_ids.reshape(b * l, t).long()
        amask = attention_mask.reshape(b * l, t)
        with torch.no_grad():  # frozen encoder
            hidden = self.text_encoder(ids, amask)
        lang_fea = self.proj(hidden)
        lang_emb = lang_fea[:, 0, :]  # CLS
        out = {"lang_fea": lang_fea, "lang_emb": lang_emb, "lang_mask": amask}
        if self.lang_cls is not None:
            out["lang_scores"] = self.lang_cls(lang_emb)
        return out


def read_hf_state_dict(bert_dir: str) -> dict:
    """The tensors of a HF BERT directory: ``model.safetensors`` where it
    exists (read without the ``safetensors`` package), else
    ``pytorch_model.bin``."""
    st_path = os.path.join(bert_dir, "model.safetensors")
    if os.path.exists(st_path):
        from vlp3d_torch.data.safetensors_file import read_safetensors

        return read_safetensors(st_path)
    return torch.load(os.path.join(bert_dir, "pytorch_model.bin"),
                      map_location="cpu", weights_only=True)


def _hf_key(sd: dict, name: str) -> str:
    return name if name in sd else "bert." + name


def bert_config_from_state_dict(sd: dict) -> BertConfig:
    """The BertConfig of a HF checkpoint's tensors (bare or ``bert.``
    names), so that a small stand-in checkpoint takes the path bert-base
    takes: its vocabulary, width, depth, feed-forward width and positions
    from the tensors' shapes, a head every 64 channels, text mode over
    the first min(6, depth) layers (``_bert_config_from_state_dict`` of
    ``vlp3d/cli/validate.py``)."""
    emb = sd[_hf_key(sd, "embeddings.word_embeddings.weight")]
    n_layers = 0
    while any(k.startswith((f"encoder.layer.{n_layers}.",
                            f"bert.encoder.layer.{n_layers}.")) for k in sd):
        n_layers += 1
    hidden = emb.shape[1]
    return BertConfig(
        vocab_size=emb.shape[0], hidden_size=hidden,
        num_hidden_layers=n_layers, num_attention_heads=max(1, hidden // 64),
        intermediate_size=sd[_hf_key(
            sd, "encoder.layer.0.intermediate.dense.weight")].shape[0],
        max_position_embeddings=sd[_hf_key(
            sd, "embeddings.position_embeddings.weight")].shape[0],
        fusion_layer=min(6, n_layers))


def load_hf_bert(encoder: BertTextEncoder, sd: dict) -> list:
    """Copy a HF BERT state dict (``bert.``-prefixed or bare names) into
    ``encoder``, each tensor's shape checked, and return the keys of
    ``sd`` it did not take, in ``sd``'s order. The encoder's names are
    HF's under ``bert.``; its layers past ``fusion_layer`` do not exist,
    so theirs are among the keys returned, as are the pooler's and any
    head's. ``position_ids`` is taken where the checkpoint has it and
    kept otherwise."""
    taken, own = set(), encoder.state_dict()
    with torch.no_grad():
        for name, dst in own.items():
            bare = name[len("bert."):]
            key = name if name in sd else bare
            if key not in sd:
                if bare == "embeddings.position_ids":
                    continue
                raise KeyError(f"the checkpoint has no {name!r} (nor "
                               f"{bare!r})")
            src = torch.as_tensor(sd[key])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{key}: shape {tuple(src.shape)}, the "
                                 f"encoder's {name} is {tuple(dst.shape)}")
            dst.copy_(src)
            taken.add(key)
    return [k for k in sd if k not in taken]


class BertMLMHead(nn.Module):
    """BertForMaskedLM's prediction head (``BertMLMHead`` in
    ``vlp3d/models/bert.py``): ``transform.dense``, exact GELU,
    ``transform.LayerNorm``, then the vocabulary ``decoder``."""

    def __init__(self, c: BertConfig = BertConfig(), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.transform = nn.Module()
        self.transform.dense = nn.Linear(c.hidden_size, c.hidden_size,
                                         device=device)
        self.transform.LayerNorm = nn.LayerNorm(
            c.hidden_size, eps=c.layer_norm_eps, device=device)
        self.decoder = nn.Linear(c.hidden_size, c.vocab_size, device=device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.transform.dense(hidden))
        return self.decoder(self.transform.LayerNorm(x))


def sample_sentences(b: int, n: int, generator: torch.Generator | None,
                     device) -> torch.Tensor:
    """:class:`LangCrossMLM`'s draw: one sentence of the ``n`` of the
    flattened batch for each of the ``b`` scene rows, uniformly."""
    return torch.randint(0, n, (b,), generator=generator, device=device)


class LangCrossMLM(nn.Module):
    """The proposal-conditioned MLM head (``LangCrossMLM`` in
    ``vlp3d/models/bert.py``; the reference's dormant
    ``LangBertModule.mlm``, lang_bert_module.py:142-249). For each scene
    row one sentence is drawn from the flattened (B * L) pool
    (:func:`sample_sentences`), 80/10/10-masked
    (:func:`~vlp3d_torch.models.caption.mask_caption_tokens` at
    ``mask_ratio``), re-encoded by the frozen text encoder and projected
    to ``hidden_size``; then ``depth`` post-LN attention blocks
    (``cross_attn_{i}``) attend to the positive-proposal features of the
    drawn sentence's scene (``pc_proj`` + exact GELU), and the prediction
    head scores every position. Both draws come from ``generator`` (on
    the inputs' device; the global generator when None). Starts in
    evaluation mode; ``forward(..., train=True)`` switches it (the
    dropout of the attention blocks and of the frozen encoder)."""

    def __init__(self, depth: int = 2, heads: int = 4, hidden_size: int = 128,
                 mask_ratio: float = 0.15,
                 bert_config: BertConfig = BertConfig(), *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.mask_ratio = mask_ratio
        self.vocab_size = bert_config.vocab_size
        self.text_encoder = BertTextEncoder(bert_config, device=device)
        self.text_encoder.requires_grad_(False)  # frozen in the reference
        self.proj = nn.Linear(bert_config.hidden_size, hidden_size,
                              device=device)
        self.pc_proj = nn.Linear(hidden_size, hidden_size, device=device)
        self.cross_attn = nn.ModuleList(
            MultiHeadAttention(hidden_size, heads, device=device)
            for _ in range(depth))
        self.prediction = PredictionHead(bert_config.vocab_size, hidden_size,
                                         device=device)
        self.eval()

    def forward(self, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                bbox_feature: torch.Tensor, positive_labels: torch.Tensor,
                *, train: bool = False,
                generator: torch.Generator | None = None):
        """input_ids, attention_mask (B, L, T); bbox_feature (B, K, H);
        positive_labels (B, L) or (B * L,) -> (logits (B, T, vocab), the
        drawn sentences' ids (B, T), the masked positions (B, T) bool)."""
        if self.training != train:
            self.train(train)
        b, l, t = input_ids.shape
        sel = torch.gather(bbox_feature, 1, positive_labels.reshape(b, l)
                           .long()[..., None].expand(-1, -1,
                                                     bbox_feature.shape[-1]))
        sample = sample_sentences(b, b * l, generator, input_ids.device)
        tokens = input_ids.reshape(b * l, t)[sample].long()
        mask = attention_mask.reshape(b * l, t)[sample].float()
        memory = sel[torch.div(sample, l, rounding_mode="floor")]
        mlm_ids, masked = mask_caption_tokens(tokens, self.vocab_size,
                                              self.mask_ratio,
                                              generator=generator)
        with torch.no_grad():  # frozen encoder
            hidden = self.text_encoder(mlm_ids, mask)
        x = self.proj(hidden)
        mem = F.gelu(self.pc_proj(memory))
        for block in self.cross_attn:
            x = block(x, mem, mem)
        return self.prediction(x), tokens, masked


def cross_mlm_loss(logits: torch.Tensor, targets: torch.Tensor,
                   masked: torch.Tensor) -> torch.Tensor:
    """Cross entropy over the masked positions (``cross_mlm_loss`` in
    ``vlp3d/models/bert.py``; the reference's -100-filled targets,
    lang_bert_module.py:247-249): the mean over masked positions, 0 when
    none is masked."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    n = torch.clamp(masked.sum(), min=1)
    return torch.where(masked, nll, torch.zeros_like(nll)).sum() / n
