"""Grounding evaluation and checkpoints of the port, on the CPU.

``vlp3d_torch.eval`` is the port's own copy of the numpy
``vlp3d.eval.box_iou`` and ``vlp3d.eval.grounding``: on the same seeded
model outputs and batches they must give the same numbers. The
checkpoints (``vlp3d_torch.train.checkpoint``) are ``torch.save`` files:
a best-model snapshot round-trips into a strictly loaded model, the
resume checkpoint alternates its A/B slots, and a save cut between the
slot write and the meta write leaves the previous checkpoint loadable.
Nothing here imports the JAX models.
"""

import json
import os

import numpy as np
import pytest
import torch
from torch import nn

import vlp3d.eval.box_iou as jax_box_iou
import vlp3d.eval.grounding as jax_grounding
import vlp3d_torch.eval.box_iou as box_iou
import vlp3d_torch.eval.grounding as grounding
from vlp3d_torch.data.dataset import BatchIterator
from vlp3d_torch.data.synthetic import make_synthetic_dataset, tiny_config
from vlp3d_torch.models.jointnet import init_weights_
from vlp3d_torch.models.voting import VotingModule
from vlp3d_torch.train import checkpoint
from vlp3d_torch.train.optimizer import make_optimizer

K = 16


def test_box_iou_and_corners_equal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        size = rng.uniform(0.2, 2.0, 3)
        heading = float(rng.uniform(-np.pi, np.pi))
        center = rng.normal(size=3).astype(np.float32)
        want = jax_box_iou.get_3d_box(size, heading, center)
        got = box_iou.get_3d_box(size, heading, center)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        c2 = center + rng.normal(0, 0.3, 3)
        s2 = size * rng.uniform(0.7, 1.3, 3)
        other = box_iou.construct_bbox_corners(c2, s2)
        assert np.array_equal(other,
                              jax_box_iou.construct_bbox_corners(c2, s2))
        assert (box_iou.box3d_iou(got, other)
                == jax_box_iou.box3d_iou(want, other))
    batch1 = rng.normal(size=(4, 8, 3))
    batch2 = batch1 + rng.normal(0, 0.2, (4, 8, 3))
    assert np.array_equal(box_iou.box3d_iou(batch1, batch2),
                          jax_box_iou.box3d_iou(batch1, batch2))


def _outputs_and_batches(seed):
    """Seeded model outputs over the batches of a small synthetic val
    split: proposals near the GT boxes, so IoUs above 0.25 and 0.5
    occur, and random confidences, objectness and class scores."""
    config = tiny_config()
    ds = make_synthetic_dataset(config, n_scenes=4, n_points=600,
                                anns_per_scene=7, split="val", seed=seed)
    rng = np.random.default_rng(seed)
    pairs = []
    for batch in BatchIterator(ds, 3, drop_last=False):
        b, l = batch["input_ids"].shape[:2]
        gt = batch["center_label"][:, np.arange(K) % 4]
        size = (config.dataset.mean_size_arr()[batch["size_class_label"]]
                + batch["size_residual_label"])[:, np.arange(K) % 4]
        out = {
            "objectness_scores": rng.normal(size=(b, K, 2)).astype(
                np.float32),
            "cluster_ref": rng.normal(size=(b * l, K)).astype(np.float32),
            "pred_center": (gt + rng.normal(0, 0.05, gt.shape)).astype(
                np.float32),
            "pred_size": (size * rng.uniform(0.8, 1.25, size.shape)).astype(
                np.float32),
            "pred_heading": np.zeros((b, K), np.float32),
            "sem_cls_scores": rng.normal(size=(b, K, 18)).astype(np.float32),
            "lang_scores": rng.normal(size=(b * l, 18)).astype(np.float32),
        }
        extra = dict(
            cluster_labels=rng.integers(0, 2, (b * l, K)),
            objectness_label=rng.integers(0, 2, (b, K)),
            objectness_mask=rng.integers(0, 2, (b, K)).astype(np.float32),
            object_assignment=rng.integers(0, 4, (b, K)),
        )
        arrays = {k: v for k, v in batch.items() if not isinstance(v, list)}
        pairs.append((out, arrays, extra))
    return pairs, config.dataset.mean_size_arr()


@pytest.mark.parametrize("seed", [0, 1])
def test_get_eval_and_breakdown_equal(seed):
    pairs, mean_size = _outputs_and_batches(seed)
    lists = {"jax": ([], [], []), "port": ([], [], [])}
    for out, arrays, extra in pairs:
        for with_extra in (False, True):
            kw = extra if with_extra else {}
            want = jax_grounding.get_eval(out, arrays, mean_size_arr=mean_size,
                                          **kw)
            got = grounding.get_eval(out, arrays, mean_size_arr=mean_size,
                                     **kw)
            assert set(got) == set(want)
            for k, w in want.items():
                g = got[k]
                if k in ("pred_bboxes", "gt_bboxes"):
                    assert all(np.array_equal(x, y) for x, y in zip(g, w))
                    assert len(g) == len(w)
                else:
                    assert g == w, k
        for name, g in (("jax", want), ("port", got)):
            for acc, key in zip(lists[name], ("ref_iou", "ref_multiple_mask",
                                              "ref_others_mask")):
                acc += g[key]
    ious = np.asarray(lists["port"][0])
    assert (ious >= 0.25).any() and (ious >= 0.5).any() and (ious < 0.25).any()
    want = jax_grounding.final_eval_breakdown(*lists["jax"])
    got = grounding.final_eval_breakdown(*lists["port"])
    assert got == want
    assert got["overall_acc@0.25"] > 0


class _Heads(nn.Module):
    """A small stand-in for JointNet (whose frozen BERT-base alone would
    make each snapshot ~270 MB): a voting module with BatchNorm
    statistics, a match head in the module learning-rate group and, with
    ``use_con``, a contrast head."""

    def __init__(self, use_con=True):
        super().__init__()
        self.vgen = VotingModule(1, 32, device="cpu")
        self.match = nn.Sequential(nn.Linear(16, 8), nn.Linear(8, 1))
        if use_con:
            self.constrast = nn.Linear(8, 8)
        init_weights_(self, 0)


def _model(use_con=True):
    return _Heads(use_con)


def _step(model, optimizer, seed):
    """One optimizer update from seeded gradients."""
    g = torch.Generator().manual_seed(seed)
    for group in optimizer.param_groups:
        for p in group["params"]:
            p.grad = torch.randn(p.shape, generator=g) * 0.01
    optimizer.step()


def _same_state(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_params_snapshot_round_trip_strict(tmp_path):
    model = _model()
    path = checkpoint.save_params(str(tmp_path), "model", model.state_dict())
    assert path == os.path.join(str(tmp_path), "model.pth")
    fresh = _model()
    init_weights_(fresh, 5)
    sd = checkpoint.load_params(str(tmp_path), "model")
    fresh.load_state_dict(sd, strict=True)
    _same_state(fresh.state_dict(), model.state_dict())
    # a model without the contrast head refuses it strictly ...
    with pytest.raises(RuntimeError, match="Unexpected key"):
        _model(use_con=False).load_state_dict(sd, strict=True)
    # ... and takes every key it has through the partial warm start
    small = _model(use_con=False)
    init_weights_(small, 6)
    template = small.state_dict()
    template["match.match.0.weight"] = torch.zeros(3, 3)
    merged, restored, skipped = checkpoint.load_params_partial(path, template)
    assert skipped == 1 and restored == len(template) - 1
    assert torch.equal(merged["match.match.0.weight"], torch.zeros(3, 3))
    for k in template:
        if k != "match.match.0.weight":
            assert torch.equal(merged[k], sd[k]), k


def test_resume_checkpoint_round_trip_and_ab_slots(tmp_path, monkeypatch):
    root = str(tmp_path)
    model = _model()
    optimizer = make_optimizer(model)
    saved = {}
    for epoch, slot in ((1, "checkpoint_a"), (2, "checkpoint_b"),
                        (3, "checkpoint_a")):
        _step(model, optimizer, epoch)
        best = {"sum": np.float32(0.1 * epoch), "iou_rate_0.5": epoch / 10}
        assert checkpoint.save_checkpoint(root, model, optimizer, best,
                                          epoch) == slot
        meta = json.load(open(os.path.join(root, "checkpoint_meta.json")))
        assert meta["dir"] == slot and meta["epoch"] == epoch
        assert meta["best"]["sum"] == float(np.float32(0.1 * epoch))
        saved[epoch] = ({k: v.clone() for k, v in model.state_dict().items()},
                        optimizer.step_count)
    assert sorted(os.listdir(root)) == ["checkpoint_a", "checkpoint_b",
                                        "checkpoint_meta.json"]

    def restored():
        fresh = _model()
        init_weights_(fresh, 9)
        opt = make_optimizer(fresh)
        meta = checkpoint.load_checkpoint(root, fresh, opt)
        return fresh, opt, meta

    fresh, opt, meta = restored()
    assert meta["epoch"] == 3
    _same_state(fresh.state_dict(), saved[3][0])
    assert opt.step_count == saved[3][1] == 3
    # the restored optimizer takes the same next step as the saved one
    _step(model, optimizer, 4)
    _step(fresh, opt, 4)
    _same_state(fresh.state_dict(), model.state_dict())

    # a save cut after its slot is written and before the meta flips:
    # the meta still names the previous slot, which is intact
    def killed(root, meta):
        raise KeyboardInterrupt("killed before the meta write")

    monkeypatch.setattr(checkpoint, "_write_meta", killed)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(root, model, optimizer, {"sum": 9.0}, 4)
    monkeypatch.undo()
    fresh, opt, meta = restored()
    assert meta["epoch"] == 3 and meta["dir"] == "checkpoint_a"
    _same_state(fresh.state_dict(), saved[3][0])
    # the next save goes to the slot the meta does not name again
    assert checkpoint.save_checkpoint(root, model, optimizer, {"sum": 1.0},
                                      5) == "checkpoint_b"
    fresh, _, meta = restored()
    assert meta["epoch"] == 5
    _same_state(fresh.state_dict(), model.state_dict())
