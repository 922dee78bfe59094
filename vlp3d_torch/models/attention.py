"""Transformer primitives for the relation and match heads.

Counterparts of ``MultiHeadAttention``, ``PositionwiseFeedForward`` and
``CrossAttentionDecoderLayer`` in ``vlp3d/models/attention.py``, with
the JAX module's dropout sites (after the output projection, inside the
feed-forward, on the feed-forward's output; the identity at evaluation).
Attention is written out as matmul + softmax, as the JAX module does. Parameter names follow the reference
(``attention.fc_q``, ``layer_norm``, ``ffn.linear1``, ``norm``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.layers import Dropout


DROPOUT = 0.1  # every dropout site of these modules, as in the reference


class ScaledDotProductAttention(nn.Module):
    """q/k/v/o projections + scaled dot-product attention."""

    def __init__(self, d_model: int, heads: int, device):
        super().__init__()
        self.heads = heads
        self.fc_q = nn.Linear(d_model, d_model, device=device)
        self.fc_k = nn.Linear(d_model, d_model, device=device)
        self.fc_v = nn.Linear(d_model, d_model, device=device)
        self.fc_o = nn.Linear(d_model, d_model, device=device)

    def forward(self, queries, keys, values, attention_mask=None,
                attention_weights=None, way: str = "add"):
        b, nq, d = queries.shape
        nk = keys.shape[1]
        h, dk = self.heads, d // self.heads
        q = self.fc_q(queries).reshape(b, nq, h, dk).transpose(1, 2)
        k = self.fc_k(keys).reshape(b, nk, h, dk).transpose(1, 2)
        v = self.fc_v(values).reshape(b, nk, h, dk).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
        if attention_weights is not None:
            att = (att * attention_weights if way == "mul"
                   else att + attention_weights)
        if attention_mask is not None:
            # mask==0 positions are replaced (attention.py:74-75)
            att = att.masked_fill(attention_mask == 0, -10000.0)
        att = torch.softmax(att, dim=-1)
        out = torch.matmul(att, v).transpose(1, 2).reshape(b, nq, d)
        return self.fc_o(out), att


class MultiHeadAttention(nn.Module):
    """Post-LN residual attention: out = LN(q + dropout(att(q, k, v))),
    eps 1e-5."""

    def __init__(self, d_model: int = 128, heads: int = 4, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.attention = ScaledDotProductAttention(d_model, heads, device)
        self.dropout = Dropout(DROPOUT)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-5, device=device)

    def forward(self, queries, keys, values, *, attention_mask=None,
                attention_weights=None, way: str = "add",
                return_attention: bool = False):
        out, att = self.attention(queries, keys, values, attention_mask,
                                  attention_weights, way)
        out = self.layer_norm(queries + self.dropout(out))
        return (out, att) if return_attention else out


class PositionwiseFeedForward(nn.Module):
    def __init__(self, d_model: int = 128, hidden: int = 256, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.linear1 = nn.Linear(d_model, hidden, device=device)
        self.linear2 = nn.Linear(hidden, d_model, device=device)
        self.dropout = Dropout(DROPOUT)

    def forward(self, x):
        return self.linear2(self.dropout(F.relu(self.linear1(x))))


class CrossAttentionDecoderLayer(nn.Module):
    """self-attn -> cross-attn -> FFN with one final LN (mmattention.py:53-87)."""

    def __init__(self, hidden_size: int = 128, ffn_hidden: int = 256,
                 heads: int = 4, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.self_attention = MultiHeadAttention(hidden_size, heads,
                                                 device=device)
        self.enc_dec_attention = MultiHeadAttention(hidden_size, heads,
                                                    device=device)
        self.ffn = PositionwiseFeedForward(hidden_size, ffn_hidden,
                                           device=device)
        self.dropout = Dropout(DROPOUT)
        self.norm = nn.LayerNorm(hidden_size, eps=1e-5, device=device)

    def forward(self, query, key, value, *, src_mask=None, src_trg_mask=None):
        x = self.self_attention(query, query, query, attention_mask=src_mask)
        x = self.enc_dec_attention(x, key, value, attention_mask=src_trg_mask)
        return self.norm(x + self.dropout(self.ffn(x)))
