"""Object-level contrastive module: OCC (object <-> text) and OSC
(object <-> object).

Counterpart of ``vlp3d/models/contrast.py``
(constrast_module.py:40-131) as fixed-shape masked math: axis-aligned
IoU between the per-sentence GT box (+1e-2 on its size) and the detached
predicted boxes picks the positives (IoU > 0.25); positive-objectness
selection is a mask on the similarity logits (masked log-softmax, means
normalised by the object count); for OCC only the object-side
SoftCrossEntropy term survives (/2); both losses are divided by the
batch size and are zero before epoch 50 (under data parallel, ``shard``,
the sums and the batch size are the global batch's). The learnable
temperature
``nce_loss.tau`` exists in the reference and is unused there; it is kept
so that the state dict carries it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from vlp3d_torch.device import resolve_device
from vlp3d_torch.geometry.boxes import box3d_iou_aabb
from vlp3d_torch.parallel.reduce import LOCAL

_NEG = -1e9


def _l2norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(norm, min=eps)


class _Tau(nn.Module):
    def __init__(self, device):
        super().__init__()
        self.tau = nn.Parameter(
            torch.full((1,), math.log(1.0 / 0.07), device=device))


class ContrastModule(nn.Module):
    shard = LOCAL

    def __init__(self, hidden: int = 128, iou_threshold: float = 0.25, *,
                 device=None):
        super().__init__()
        device = resolve_device(device)
        self.iou_threshold = iou_threshold
        self.pc_proj = nn.Linear(hidden, hidden, bias=False, device=device)
        self.text_proj = nn.Linear(hidden, hidden, bias=False, device=device)
        # the reference wraps this projection in a Sequential
        self.pc_proj_iou = nn.Sequential(
            nn.Linear(hidden, hidden, bias=False, device=device))
        self.nce_loss = _Tau(device)

    def forward(self, bbox_feature, lang_emb, pred_center, pred_size,
                gt_center, gt_size, objectness_masks, lang_num, epoch) -> dict:
        """bbox_feature (B, K, H); lang_emb (B*L, H); pred_center/size
        (B, K, 3); gt_center/size (B, L, 3) per-sentence reference boxes;
        objectness_masks (B, K) float; lang_num (B,); epoch scalar ->
        lang_con_loss, iou_con_loss (scalars)."""
        b, k, h = bbox_feature.shape
        l = gt_center.shape[1]
        lang_emb = lang_emb.reshape(b, l, h)

        with torch.no_grad():
            ious = box3d_iou_aabb(
                gt_center[:, :, None, :], gt_size[:, :, None, :] + 1e-2,
                pred_center[:, None, :, :], pred_size[:, None, :, :])
            target = (ious > self.iou_threshold).float()  # (B, L, K)

        obj_mask = objectness_masks  # (B, K)
        obj_cnt = torch.clamp(obj_mask.sum(dim=-1), min=1.0)  # (B,)
        lang_mask = (torch.arange(l, device=lang_num.device)[None, :]
                     < lang_num[:, None]).float()
        col_mask = obj_mask[:, None, :] > 0  # (B, 1, K)

        # OCC: text CLS against proposal features
        text_n = _l2norm(self.text_proj(lang_emb))  # (B, L, H)
        box_n = _l2norm(self.pc_proj(bbox_feature))  # (B, K, H)
        sim_lang = torch.einsum("blh,bkh->blk", text_n, box_n)
        logp = F.log_softmax(
            torch.where(col_mask, sim_lang, sim_lang.new_tensor(_NEG)), dim=-1)
        occ_per = -(logp * target * obj_mask[:, None, :]).sum(dim=-1)
        occ_per = occ_per / obj_cnt[:, None] / 2.0
        sh = self.shard
        lang_con_loss = sh.sum((occ_per * lang_mask).sum()) / (b * sh.world)

        # OSC: proposal against proposal
        box_iou_n = _l2norm(self.pc_proj_iou(bbox_feature))
        sim_iou = torch.einsum("bkh,bjh->bkj", box_iou_n, box_iou_n)
        pair_mask = obj_mask[:, :, None] * obj_mask[:, None, :]  # (B, K, K)
        neg = sim_iou.new_tensor(_NEG)
        logp_iou = F.log_softmax(torch.where(col_mask, sim_iou, neg), dim=-1)
        logp_iou_t = F.log_softmax(
            torch.where(col_mask, sim_iou.transpose(1, 2), neg), dim=-1)
        # sum_{k,j} logp[k,j] t[l,k] t[l,j] pair[k,j], without the
        # (B, L, K, K) outer product
        osc = -torch.einsum("bkj,blk,blj->bl",
                            (logp_iou + logp_iou_t) * pair_mask,
                            target, target)
        osc_per = osc / 2.0 / (obj_cnt ** 2)[:, None]
        iou_con_loss = sh.sum((osc_per * lang_mask).sum()) / (b * sh.world)

        gate = (torch.as_tensor(epoch, device=lang_con_loss.device)
                >= 50).float()
        return {"lang_con_loss": lang_con_loss * gate,
                "iou_con_loss": iou_con_loss * gate}
