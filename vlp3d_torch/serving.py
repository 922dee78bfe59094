"""Grounding, captioning and question-answering inference executors.

Counterpart of ``vlp3d/serving.py``'s ``GroundingPredictor``,
``CaptionPredictor`` and ``AnswerPredictor``: ``predictor(batches)`` runs
a list of equally-shaped host batches and returns one host dict per
batch; ``run_padded(batch_k)`` runs one batch of k <= batch_size
occupied rows, transferring only those rows and padding to batch_size
on the device by repeating row 0 (the micro-batcher's convention).

``devices`` (a mesh of :mod:`vlp3d_torch.parallel.mesh`, e.g.
``make_mesh()``) serves data-parallel, as the JAX predictors' ``mesh``
does: one replica of the weights a device, each batch's rows split into
contiguous blocks, one a device (batch_size must divide by the device
count), and the outputs concatenated back in row order. Each device's
block is launched before any result is read, so the devices' work
overlaps.

The per-sentence prediction is the argmax of objectness-masked
confidences (eval_ground.py:100-120): ``argmax(cluster_ref * mask)``,
which picks a masked proposal when every unmasked confidence is negative,
as the reference does. A caption is decoded for every proposal from its
aggregated feature (greedy, KV-cached; beam search with ``num_beams`` >
1). An answer is the top-k of each question's answer logits, ties to the
lowest answer index (``lax.top_k``'s order).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vlp3d_torch.config import Config
from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.caption import beam_decode, greedy_decode, top_k_first
from vlp3d_torch.models.jointnet import JointNet
from vlp3d_torch.parallel.mesh import shard_batch

# batch keys the grounding forward consumes (everything else is labels;
# the JAX stream's per-step scalars epoch/istrain/random are train-only)
STREAM_KEYS = (
    "point_clouds", "input_ids", "bert_attention_mask", "lang_num",
)


def to_device(batch: dict, device) -> dict:
    """The STREAM_KEYS arrays of a host batch, on ``device`` (a pageable
    copy)."""
    return {k: torch.as_tensor(np.asarray(batch[k])).to(device)
            for k in STREAM_KEYS}


@torch.no_grad()
def ground(model: JointNet, batch: dict) -> dict:
    """One device batch (tensors on the model's device) -> device
    predictions: ``pred_ref`` (B, L), the chosen proposal of each
    sentence slot, and the model's boxes and ``cluster_ref``."""
    if model.config.model.no_reference:
        raise ValueError("a no_reference model has no grounding head (no "
                         "cluster_ref) to ground sentences with")
    out = model(batch, is_eval=True)
    masks = out["objectness_masks"]  # (B, K)
    bsz, l = batch["input_ids"].shape[:2]
    conf = out["cluster_ref"].reshape(bsz, l, -1)
    return {
        "pred_ref": torch.argmax(conf * masks[:, None, :], dim=-1),
        "pred_center": out["pred_center"],
        "pred_size": out["pred_size"],
        "pred_heading": out["pred_heading"],
        "cluster_ref": out["cluster_ref"],
    }


# the caption task's per-proposal outputs besides the caption ids
CAPTION_KEYS = ("pred_center", "pred_size", "pred_heading",
                "objectness_scores", "sem_cls_scores")


@torch.no_grad()
def decode_captions(model: JointNet, features: torch.Tensor, *,
                    num_beams: int = 1,
                    length_penalty: float = 1.0) -> torch.Tensor:
    """Caption ids (B, K, max_des_len + 2) of every proposal from its
    aggregated feature (B, K, C), through the model's caption decoder."""
    b, k, c = features.shape
    obj_token = features.reshape(b * k, 1, c)
    decoder = model.caption.model
    max_len = model.config.model.max_des_len
    if num_beams > 1:
        ys, _ = beam_decode(decoder, obj_token, max_len, num_beams,
                            length_penalty=length_penalty)
    else:
        ys = greedy_decode(decoder, obj_token, max_len)
    return ys.reshape(b, k, -1)


def _pad_rows(dev: dict, rows: int, first: dict) -> dict:
    """Each tensor of ``dev`` padded to ``rows`` rows on its device by
    repeating ``first``'s row 0 (the batch's row 0)."""
    return {key: torch.cat([v, first[key][:1].expand(
        (rows - v.shape[0],) + v.shape[1:])]) for key, v in dev.items()}


class GroundingPredictor:
    """ScanRefer grounding inference on one device, or data-parallel over
    ``devices``.

    ``state_dict``: the reference-layout weights
    (:func:`vlp3d_torch.convert.jax_to_torch_state_dict`), loaded
    strictly; None keeps the model's seeded random initialisation, the
    same on every replica.
    """

    def __init__(self, config: Config, state_dict: dict | None = None, *,
                 batch_size: int = 8, device=None, devices=None):
        if devices is not None and device is not None:
            raise ValueError("pass device or devices, not both")
        self.devices = [resolve_device(d) for d in (devices or [device])]
        if batch_size % len(self.devices):
            raise ValueError(
                f"batch_size={batch_size} must be divisible by the "
                f"{len(self.devices)}-device serving mesh")
        self.device = self.devices[0]
        self.config = config
        self.batch_size = batch_size
        self.models = []
        for d in self.devices:
            model = JointNet(config, device=d)
            model.requires_grad_(False)
            if state_dict is not None:
                model.load_state_dict(state_dict, strict=True)
            self.models.append(model)
        self.model = self.models[0]

    def _to_device(self, batch: dict) -> dict:
        return to_device(batch, self.device)

    def predict_with(self, model: JointNet, batch: dict) -> dict:
        """One device batch (tensors on ``model``'s device) -> device
        predictions."""
        return ground(model, batch)

    def predict(self, batch: dict) -> dict:
        """One device batch (tensors on the first device) -> device
        predictions."""
        return self.predict_with(self.model, batch)

    @staticmethod
    def _to_host(out: dict) -> dict:
        return {k: v.cpu().numpy() for k, v in out.items()}

    def _run_blocks(self, blocks: list) -> dict:
        """Each device's block of rows through its replica, every block
        launched before any is read -> the host outputs in row order."""
        outs = [self.predict_with(m, b) for m, b in zip(self.models, blocks)]
        if len(outs) == 1:
            return self._to_host(outs[0])
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in outs[0]}

    def __call__(self, batches: list[dict]) -> list[dict]:
        """batches: host batch dicts with STREAM_KEYS arrays."""
        return [self._run_blocks(shard_batch(
            self.devices, {k: b[k] for k in STREAM_KEYS})) for b in batches]

    def run_padded(self, batch_k: dict) -> dict:
        """Run k <= batch_size occupied rows; rows past k repeat row 0 on
        the device, and the result keeps all batch_size rows. Each device
        copies its occupied rows (and row 0, where its block holds none)
        and pads its block on the device."""
        k = np.shape(batch_k["point_clouds"])[0]
        if k > self.batch_size:
            raise ValueError(f"occupancy {k} > batch_size {self.batch_size}")
        per = self.batch_size // len(self.devices)
        blocks = []
        for i, d in enumerate(self.devices):
            lo, hi = i * per, min((i + 1) * per, k)
            dev = to_device({key: np.asarray(v)[lo:max(hi, lo)]
                             for key, v in batch_k.items()}, d)
            if hi - lo < per:  # padding repeats the batch's row 0
                first = dev if lo == 0 else to_device(
                    {key: np.asarray(v)[:1] for key, v in batch_k.items()},
                    d)
                dev = _pad_rows(dev, per, first)
            blocks.append(dev)
        return self._run_blocks(blocks)


class CaptionPredictor(GroundingPredictor):
    """Scan2Cap inference on one device (or over ``devices``): the
    grounding forward at ``is_eval``, then a caption for each of the B x K
    proposals (greedy decode, or beam search when ``num_beams`` > 1). Its
    predictions are
    ``caption_ids`` (B, K, max_des_len + 2) and the proposals' boxes,
    objectness and class scores (``vlp3d/serving.py:238-245``). The model
    carries the caption decoder whatever ``config.model.no_caption``
    says."""

    def __init__(self, config: Config, state_dict: dict | None = None, *,
                 batch_size: int = 8, device=None, devices=None,
                 num_beams: int = 1, length_penalty: float = 1.0):
        config = dataclasses.replace(config, model=dataclasses.replace(
            config.model, no_caption=False))
        super().__init__(config, state_dict, batch_size=batch_size,
                         device=device, devices=devices)
        self.num_beams = num_beams
        self.length_penalty = length_penalty

    @torch.no_grad()
    def forward(self, batch: dict, model: JointNet | None = None) -> dict:
        """The grounding forward of one device batch (on the first
        replica unless ``model`` is given)."""
        return (model or self.model)(batch, is_eval=True)

    def decode(self, out: dict, model: JointNet | None = None) -> dict:
        """The forward's outputs -> the caption predictions."""
        ids = decode_captions(model or self.model,
                              out["aggregated_vote_features"],
                              num_beams=self.num_beams,
                              length_penalty=self.length_penalty)
        return {"caption_ids": ids, **{k: out[k] for k in CAPTION_KEYS}}

    def predict_with(self, model: JointNet, batch: dict) -> dict:
        return self.decode(self.forward(batch, model), model)


@torch.no_grad()
def answer(model: JointNet, batch: dict, topk: int = 10) -> dict:
    """One device batch -> the top ``topk`` answers of each question slot
    (all of them when the vocabulary is smaller): ``answer_top_ids`` /
    ``answer_top_scores`` (B, L, k), descending, ties to the lowest id,
    and the logits ``answer_scores`` (B, L, A)."""
    out = model(batch, is_eval=True)
    scores = out["answer_scores"]  # (B*L, A)
    b, l = batch["input_ids"].shape[:2]
    top_scores, top_ids = top_k_first(scores, min(topk, scores.shape[1]))
    return {
        "answer_scores": scores.reshape(b, l, -1),
        "answer_top_ids": top_ids.reshape(b, l, -1),
        "answer_top_scores": top_scores.reshape(b, l, -1),
    }


class AnswerPredictor(GroundingPredictor):
    """ScanQA inference on one device (or over ``devices``): the joint
    forward at ``is_eval`` with the answer head, then the top ``topk``
    answer ids and logits of each question (``vlp3d/serving.py:253-283``).
    The model carries the answer head whatever ``config.model.use_answer``
    says.

    The JAX predictor returns its top-k as (B * L, topk) rows, which its
    HTTP service then splits by request as if they were (B, ...): the
    rows of request i's questions are not row i. These predictions are
    (B, L, topk), so a request's answers are its own."""

    def __init__(self, config: Config, state_dict: dict | None = None, *,
                 topk: int = 10, batch_size: int = 8, device=None,
                 devices=None):
        config = dataclasses.replace(config, model=dataclasses.replace(
            config.model, use_answer=True))
        super().__init__(config, state_dict, batch_size=batch_size,
                         device=device, devices=devices)
        self.topk = topk

    def predict_with(self, model: JointNet, batch: dict) -> dict:
        return answer(model, batch, self.topk)
