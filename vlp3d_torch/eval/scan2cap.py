"""Scan2Cap candidates of one evaluated batch: decode, assign, collect.

The device half of the caption evaluation that the JAX package writes out
in ``Solver.caption_eval`` and ``vlp3d/cli/caption_eval.py`` (eval_cap,
lib/joint/eval_helper.py:278-357): a caption for every proposal, the GT
object each proposal is assigned to (``compute_objectness_loss``), then
the host half, :func:`vlp3d_torch.eval.captioning.collect_caption_candidates`.
"""

from __future__ import annotations

import torch

from vlp3d_torch.eval.captioning import collect_caption_candidates
from vlp3d_torch.losses.detection import compute_objectness_loss
from vlp3d_torch.serving import decode_captions

# the forward's outputs the host half reads
HOST_KEYS = ("pred_center", "pred_size", "pred_heading",
             "objectness_scores", "sem_cls_scores")


def collect_batch(model, out: dict, arrays: dict, scene_ids, tokenizer,
                  organized: dict, candidates: dict, *, num_beams: int = 1,
                  length_penalty: float = 1.0) -> dict:
    """``out``: the model's forward outputs (on its device) of the batch
    whose host arrays are ``arrays`` and scene ids ``scene_ids``; adds the
    batch's candidates to ``candidates`` and returns it."""
    ids = decode_captions(model, out["aggregated_vote_features"],
                          num_beams=num_beams, length_penalty=length_penalty)
    xyz = out["aggregated_vote_xyz"]
    centers = torch.as_tensor(arrays["center_label"][..., :3]).to(xyz.device)
    with torch.no_grad():
        assignment = compute_objectness_loss(
            xyz, out["objectness_scores"], centers)[3]
    host = {k: out[k].cpu().numpy() for k in HOST_KEYS}
    host["lang_cap_ids"] = ids.cpu().numpy()
    return collect_caption_candidates(
        host, {**arrays, "scene_id": scene_ids}, tokenizer, organized,
        object_assignment=assignment.long().cpu().numpy(),
        candidates=candidates)
