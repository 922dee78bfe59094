"""GloVe/LSTM language encoder of the single-task pipelines (ScanQA with
MCAN, RefNet).

Counterpart of ``vlp3d/models/lang_lstm.py`` (the reference's
``models/vqa/lang_module.py:12-120``): word embeddings -> dropout -> an
LSTM (bidirectional with ``use_bidir``) -> per-token features, masked
beyond each row's length, the final state as the sentence embedding,
and an optional object-class classifier over it.

The JAX module runs flax ``nn.RNN`` over every step of the padded
sequence with ``seq_lengths``; the port reproduces it exactly rather than
packing (``pack_padded_sequence`` refuses a length of 0):

  * forward: the cell runs over all T steps; the sentence embedding is
    the output at ``clip(len - 1, 0, T - 1)``, so a row of length 0 takes
    the output of step 0;
  * backward (``use_bidir``): each row is flipped within its length, the
    padding flipped among itself behind it (flax's ``flip_sequences``:
    position j reads (T - 1 - j + len) mod T), the cell runs over all T
    steps, and its outputs are flipped back the same way; the backward
    half of the embedding is the flipped-back output at position 0. A
    row of length 0 is then the whole padded row reversed.

The cell is flax's ``OptimizedLSTMCell``: gates i, f, g, o from an input
projection without bias and a hidden projection with bias, c' = f c +
i g, h' = o tanh(c'), zero initial state; it runs as one matmul for the
input projection of every step and a loop of T hidden matmuls (the JAX
package computes the LSTM outside any Pallas kernel). Parameters keep
torch ``nn.LSTM``'s names and layouts (``lstm.weight_ih_l0`` (4H, E),
``lstm.weight_hh_l0`` (4H, H), ``lstm.bias_hh_l0`` (4H), gate order i,
f, g, o, ``_reverse`` for the backward cell), without ``bias_ih``: the
flax cell has no input bias.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import Dropout

PDROP = 0.1  # the dropout before the LSTM and before the classifier


class LSTMWeights(nn.Module):
    """The (bidirectional) LSTM's parameters under ``nn.LSTM``'s names,
    and the cell's loop over the steps."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 bidirectional: bool, device):
        super().__init__()
        self.hidden_size = hidden_size
        h4 = 4 * hidden_size
        for sfx in ("", "_reverse") if bidirectional else ("",):
            self.register_parameter(f"weight_ih_l0{sfx}", nn.Parameter(
                torch.zeros(h4, input_size, device=device)))
            self.register_parameter(f"weight_hh_l0{sfx}", nn.Parameter(
                torch.zeros(h4, hidden_size, device=device)))
            self.register_parameter(f"bias_hh_l0{sfx}", nn.Parameter(
                torch.zeros(h4, device=device)))

    def run(self, x: torch.Tensor, sfx: str = "") -> torch.Tensor:
        """x (N, T, E) -> the hidden state after each step (N, T, H)."""
        w_hh = getattr(self, f"weight_hh_l0{sfx}")
        xp = F.linear(x, getattr(self, f"weight_ih_l0{sfx}"),
                      getattr(self, f"bias_hh_l0{sfx}"))  # (N, T, 4H)
        n, t, _ = x.shape
        h = c = x.new_zeros(n, self.hidden_size)
        outs = []
        for step in range(t):
            i, f, g, o = (xp[:, step] + F.linear(h, w_hh)).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        return torch.stack(outs, dim=1)


def flip_within_length(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """flax ``flip_sequences``' permutation of each row (N, T): position j
    reads (T - 1 - j + len) mod T, the first ``len`` steps reversed and
    the padding reversed behind them; it is its own inverse."""
    j = torch.arange(t - 1, -1, -1, device=lengths.device)
    return (j[None, :] + lengths[:, None]) % t


class LSTMLangModule(nn.Module):
    def __init__(self, input_size: int = 300, hidden_size: int = 256, *,
                 num_object_class: int = 18, use_lang_classifier: bool = True,
                 use_bidir: bool = False, device=None):
        super().__init__()
        device = resolve_device(device)
        self.use_bidir = use_bidir
        self.dropout = Dropout(PDROP)
        self.lstm = LSTMWeights(input_size, hidden_size,
                                bidirectional=use_bidir, device=device)
        width = hidden_size * (2 if use_bidir else 1)
        self.lang_cls = nn.Sequential(
            Dropout(PDROP),
            nn.Linear(width, num_object_class, device=device),
        ) if use_lang_classifier else None

    def forward(self, word_embs: torch.Tensor, lang_len: torch.Tensor):
        """word_embs (N, T, E), lang_len (N,) -> lang_fea_lstm (N, T, H or
        2H; zero beyond each length), lang_emb_lstm (N, H or 2H)[,
        lang_scores (N, num_object_class)]."""
        x = self.dropout(word_embs)
        n, t, _ = x.shape
        lens = lang_len.long()
        rows = torch.arange(n, device=x.device)
        fwd = self.lstm.run(x)
        final = fwd[rows, torch.clamp(lens - 1, 0, t - 1)]
        outputs = fwd
        if self.use_bidir:
            perm = flip_within_length(lens, t)[..., None]
            flipped = torch.gather(x, 1, perm.expand(-1, -1, x.shape[-1]))
            bwd = self.lstm.run(flipped, "_reverse")
            bwd = torch.gather(bwd, 1, perm.expand(-1, -1, bwd.shape[-1]))
            outputs = torch.cat([fwd, bwd], dim=-1)
            final = torch.cat([final, bwd[:, 0]], dim=-1)
        mask = (torch.arange(t, device=x.device)[None, :]
                < lens[:, None])[..., None]
        out = {"lang_fea_lstm": outputs * mask, "lang_emb_lstm": final}
        if self.lang_cls is not None:
            out["lang_scores"] = self.lang_cls(final)
        return out
