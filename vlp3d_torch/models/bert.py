"""BERT text encoder (text mode) + language module.

Counterpart of ``BertConfig``, ``BertEmbeddings``, ``BertLayer``,
``BertTextEncoder`` (text mode: layers [0, fusion_layer)) and
``LangModule`` in ``vlp3d/models/bert.py``. The encoder is frozen in the
reference: the port runs it under no gradient and its parameters never
require one, but in training its dropout still draws (embeddings,
attention probabilities, both sublayer outputs), as the JAX module's
does.
Parameter names follow the vendored xbert layout the reference state dict
carries (``text_encoder.bert.encoder.layer.0.attention.self.query``).
LayerNorm eps is 1e-12; the attention mask is ADDED as
(1 - mask) * -10000; GELU is the exact erf form. DistilBERT
(:func:`distilbert_config`, ``use_distil``) is the same stack with 6
layers and no token-type table.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
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


class BertLayer(nn.Module):
    def __init__(self, c: BertConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.heads = c.num_attention_heads
        self.head_dim = c.hidden_size // c.num_attention_heads
        self.attention = nn.Module()
        self.attention.self = _SelfAttention(c, device)
        self.attention.dropout = Dropout(c.attention_dropout)
        self.attention.output = _DenseLN(c.hidden_size, c, device)
        self.intermediate = nn.Module()
        self.intermediate.dense = nn.Linear(c.hidden_size,
                                            c.intermediate_size,
                                            device=device)
        self.output = _DenseLN(c.intermediate_size, c, device)

    def forward(self, x: torch.Tensor, attention_mask: torch.Tensor):
        """x (B, S, H); attention_mask (B, S) float, 1 = attend."""
        b, s, _ = x.shape
        sa = self.attention.self
        q, k, v = sa.query(x), sa.key(x), sa.value(x)
        # the heads this rank holds: all of them, or its whole heads under
        # tensor parallel (vlp3d_torch.parallel.tensor_parallel)
        dk = self.head_dim
        h = q.shape[-1] // dk
        q = q.reshape(b, s, h, dk).transpose(1, 2)
        k = k.reshape(b, s, h, dk).transpose(1, 2)
        v = v.reshape(b, s, h, dk).transpose(1, 2)
        att = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(dk)
        att = att + (1.0 - attention_mask[:, None, None, :]) * -10000.0
        att = self.attention.dropout(torch.softmax(att, dim=-1))
        ctx = torch.matmul(att, v).transpose(1, 2).reshape(b, s, h * dk)
        x = self.attention.output(ctx, x)
        y = F.gelu(self.intermediate.dense(x))  # exact erf GELU
        return self.output(y, x)


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
