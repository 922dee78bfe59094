"""MCAN (Modular Co-Attention Network) fusion blocks of the standalone
ScanQA model.

Counterpart of ``vlp3d/models/mcan.py`` (the reference's
``models/vqa/mcan_module.py``): MHAtt (post-LN residual attention), SA
(self-attention) encoder over the language tokens, SGA (self + guided
attention) decoder over the object proposals, MCAN_ED encoder-decoder
(hidden 128, 8 heads; ScanQA uses 2 layers). Masks are True where a key
is left out; its logit becomes -1e9 (``where(mask, -1e9, att)``, not
-inf), so a query whose every key is masked (a scene whose proposals all
have objectness 0) takes the uniform softmax, as in JAX, where -inf or
``scaled_dot_product_attention`` with a boolean mask would give NaN. The
norms are :class:`~vlp3d_torch.models.layers.RefLayerNorm` (std
Bessel-corrected, eps 1e-6 on the std) and GELU the tanh form, as the
JAX module's. Names follow the reference (``linear_v`` / ``linear_k`` /
``linear_q`` / ``linear_merge``, ``mlp.fc.linear``, ``norm1``,
``enc_list`` / ``dec_list``).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.answer import MLP
from vlp3d_torch.models.layers import Dropout, RefLayerNorm

MASKED = -1e9
PDROP = 0.1  # every dropout site, as in the reference


class MHAtt(nn.Module):
    def __init__(self, hidden_size: int = 128, num_heads: int = 8, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.hidden_size, self.num_heads = hidden_size, num_heads
        for name in ("linear_v", "linear_k", "linear_q", "linear_merge"):
            self.add_module(name, nn.Linear(hidden_size, hidden_size,
                                            device=device))
        self.dropout = Dropout(PDROP)

    def forward(self, v, k, q, mask=None):
        """v, k (B, Nk, H), q (B, Nq, H), mask (B, Nk) bool or None ->
        (B, Nq, H)."""
        b = q.shape[0]
        h, dh = self.num_heads, self.hidden_size // self.num_heads

        def heads(x):
            return x.reshape(b, -1, h, dh).transpose(1, 2)

        v = heads(self.linear_v(v))
        k = heads(self.linear_k(k))
        q = heads(self.linear_q(q))
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dh)
        if mask is not None:
            att = att.masked_fill(mask[:, None, None, :], MASKED)
        att = self.dropout(torch.softmax(att, dim=-1))
        out = torch.matmul(att, v).transpose(1, 2).reshape(
            b, -1, self.hidden_size)
        return self.linear_merge(out)


class FFN(nn.Module):
    """Linear to 4 x hidden, GELU, dropout, linear back."""

    def __init__(self, hidden_size: int = 128, *, device=None):
        super().__init__()
        self.mlp = MLP(hidden_size, hidden_size * 4, hidden_size,
                       device=resolve_device(device))

    def forward(self, x):
        return self.mlp(x)


class SA(nn.Module):
    def __init__(self, hidden_size: int = 128, num_heads: int = 8, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.mhatt = MHAtt(hidden_size, num_heads, device=device)
        self.ffn = FFN(hidden_size, device=device)
        self.dropout1, self.dropout2 = Dropout(PDROP), Dropout(PDROP)
        self.norm1 = RefLayerNorm(hidden_size, device=device)
        self.norm2 = RefLayerNorm(hidden_size, device=device)

    def forward(self, x, x_mask=None):
        x = self.norm1(x + self.dropout1(self.mhatt(x, x, x, x_mask)))
        return self.norm2(x + self.dropout2(self.ffn(x)))


class SGA(nn.Module):
    def __init__(self, hidden_size: int = 128, num_heads: int = 8, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.mhatt1 = MHAtt(hidden_size, num_heads, device=device)
        self.mhatt2 = MHAtt(hidden_size, num_heads, device=device)
        self.ffn = FFN(hidden_size, device=device)
        self.dropout1, self.dropout2, self.dropout3 = (
            Dropout(PDROP), Dropout(PDROP), Dropout(PDROP))
        self.norm1 = RefLayerNorm(hidden_size, device=device)
        self.norm2 = RefLayerNorm(hidden_size, device=device)
        self.norm3 = RefLayerNorm(hidden_size, device=device)

    def forward(self, x, y, x_mask=None, y_mask=None):
        x = self.norm1(x + self.dropout1(self.mhatt1(x, x, x, x_mask)))
        x = self.norm2(x + self.dropout2(self.mhatt2(y, y, x, y_mask)))
        return self.norm3(x + self.dropout3(self.ffn(x)))


class MCAN_ED(nn.Module):  # noqa: N801 — the reference's name
    def __init__(self, hidden_size: int = 128, num_heads: int = 8,
                 num_layers: int = 2, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.enc_list = nn.ModuleList(
            SA(hidden_size, num_heads, device=device)
            for _ in range(num_layers))
        self.dec_list = nn.ModuleList(
            SGA(hidden_size, num_heads, device=device)
            for _ in range(num_layers))

    def forward(self, lang, objects, lang_mask=None, obj_mask=None):
        """lang (B, T, H), objects (B, K, H), masks (B, T) / (B, K) bool,
        True where a position is left out -> (lang, objects)."""
        for enc in self.enc_list:
            lang = enc(lang, lang_mask)
        for dec in self.dec_list:
            objects = dec(objects, lang, obj_mask, lang_mask)
        return lang, objects
