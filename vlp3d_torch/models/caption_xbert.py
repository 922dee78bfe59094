"""The xbert captioner: a BertLMHeadModel over proposal features.

Counterpart of ``BertCausalLM`` and ``CaptionModuleX`` in
``vlp3d/models/caption_xbert.py`` (the reference's alternative
``models/caption_module/caption_module.py:11-272``, never wired into
JointNet):

  * the train forward embeds the caption tokens, prepends the target
    proposal's feature as an object token (after the embeddings, so the
    position ids count the word tokens only), runs the causal decoder
    layers, each cross-attending to the scene's proposal features, and
    returns the logits without the object token and the last step;
  * :meth:`CaptionModuleX.generate` decodes one caption a proposal
    greedily, ``max_len`` steps over all B * K sequences at once, each
    cross-attending to its scene's K proposals. The JAX module runs the
    whole ``max_len + 2`` sequence through the decoder at every step and
    reads the logits at step i + 1; every later position is masked
    (-10000 from the padding mask and -10000 from the causal one, whose
    softmax weight is 0 in float32), so the port runs the decoder over
    the prefix [0, i + 2) only and the LM head at the one position that
    is read. The ids are the same up to the order of summation (held by
    the tie rule); ``argmax`` takes the first index of a tie.

Geometry: hidden 128, 8 heads, feed-forward 512, depth 4, vocabulary
30522 (:func:`caption_bert_config`, CaptionModule's defaults).
:func:`vlp3d_torch.convert.caption_xbert_to_torch_state_dict` carries a
JAX tree over.
"""

from __future__ import annotations

import torch
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.bert import (
    BertConfig,
    BertEmbeddings,
    BertFusionLayer,
    BertMLMHead,
)

CLS_ID = 101
SEP_ID = 102


def caption_bert_config(hidden_size: int = 128, depth: int = 4,
                        vocab_size: int = 30522) -> BertConfig:
    return BertConfig(vocab_size=vocab_size, hidden_size=hidden_size,
                      num_hidden_layers=depth, num_attention_heads=8,
                      intermediate_size=hidden_size * 4, fusion_layer=0)


class BertCausalLM(nn.Module):
    """Causal decoder layers with per-layer cross-attention (``layer``)
    and the LM head (``cls``), on precomputed input embeddings."""

    def __init__(self, config: BertConfig, *, device=None):
        super().__init__()
        device = resolve_device(device)
        self.layer = nn.ModuleList(
            BertFusionLayer(config, causal=True, device=device)
            for _ in range(config.num_hidden_layers))
        self.cls = BertMLMHead(config, device=device)

    def hidden(self, inputs_embeds: torch.Tensor,
               attention_mask: torch.Tensor | None,
               encoder_states: torch.Tensor,
               encoder_mask: torch.Tensor | None = None) -> torch.Tensor:
        """(N, T, H) embeddings -> the last layer's (N, T, H)."""
        x = inputs_embeds
        if attention_mask is None:
            attention_mask = x.new_ones(x.shape[:2])
        for layer in self.layer:
            x = layer(x, attention_mask.float(), encoder_states,
                      encoder_mask)
        return x

    def forward(self, inputs_embeds, attention_mask=None,
                encoder_states=None, encoder_mask=None):
        """-> (logits (N, T, vocab), hidden (N, T, H))."""
        x = self.hidden(inputs_embeds, attention_mask, encoder_states,
                        encoder_mask)
        return self.cls(x), x


class CaptionModuleX(nn.Module):
    """``embeddings`` (the BERT embeddings at the caption geometry) and
    ``decoder`` (:class:`BertCausalLM`). Starts in evaluation mode."""

    def __init__(self, hidden_size: int = 128, depth: int = 4,
                 vocab_size: int = 30522, max_len: int = 32, *, device=None):
        super().__init__()
        device = resolve_device(device)
        cfg = caption_bert_config(hidden_size, depth, vocab_size)
        self.max_len = max_len
        self.embeddings = BertEmbeddings(cfg, device)
        self.decoder = BertCausalLM(cfg, device=device)
        self.eval()

    def forward(self, bbox_feature: torch.Tensor, input_ids: torch.Tensor,
                attention_mask: torch.Tensor, positive_labels: torch.Tensor,
                *, train: bool = False) -> torch.Tensor:
        """bbox_feature (B, K, H); input_ids, attention_mask (B, L, T);
        positive_labels (B, L), each sentence's proposal -> logits (B * L,
        T - 1, vocab): the logits of word positions 0 .. T - 2, each
        predicting the next token."""
        if self.training != train:
            self.train(train)
        with torch.set_grad_enabled(train):
            b, _, h = bbox_feature.shape
            l, t = input_ids.shape[1:]
            ids = input_ids.reshape(b * l, t).long()
            amask = attention_mask.reshape(b * l, t).float()
            ext_feat = bbox_feature.repeat_interleave(l, dim=0)
            target = torch.gather(ext_feat, 1, positive_labels.reshape(
                b * l).long()[:, None, None].expand(-1, 1, h))
            emb = self.embeddings(ids)
            inputs = torch.cat([target, emb], dim=1)
            mask = torch.cat([amask.new_ones(b * l, 1), amask], dim=1)
            logits, _ = self.decoder(inputs, mask, ext_feat)
            return logits[:, 1:-1, :]

    @torch.no_grad()
    def generate(self, bbox_feature: torch.Tensor) -> torch.Tensor:
        """Greedy decode of one caption a proposal: (B, K, H) -> ids (B,
        K, max_len + 1), laid out [CLS, generated ...]."""
        if self.training:
            self.train(False)
        b, k, h = bbox_feature.shape
        n = b * k
        ext_feat = bbox_feature.repeat_interleave(k, dim=0)
        target = bbox_feature.reshape(n, 1, h)
        ids = torch.zeros(n, self.max_len + 1, dtype=torch.long,
                          device=bbox_feature.device)
        ids[:, 0] = CLS_ID
        for i in range(self.max_len):
            p = i + 1  # the read position: the object token comes first
            inputs = torch.cat([target, self.embeddings(ids[:, :p])], dim=1)
            x = self.decoder.hidden(inputs, None, ext_feat)
            ids[:, p] = torch.argmax(self.decoder.cls(x[:, p]), dim=-1)
        return ids.reshape(b, k, self.max_len + 1)
