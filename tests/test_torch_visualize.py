"""The port's scene dumps, benchmark scorer and debugger hook against the
JAX package's, on the CPU.

Each writer of ``vlp3d_torch/utils/visualize.py`` gives the bytes that
``vlp3d/utils/visualize.py``'s gives on the same seeded inputs;
``eval_benchmark.evaluate`` gives JAX's dict, records whose key the GTs
lack included; ``postmortem.install`` sets the same hook, restored
afterwards.
"""

import json
import os
import sys

import numpy as np
import pytest

import vlp3d.utils.visualize as jax_vis
import vlp3d_torch.utils.visualize as port_vis
from vlp3d.cli.eval_benchmark import evaluate as jax_evaluate
from vlp3d.cli.eval_benchmark import main as jax_eval_main
from vlp3d_torch.cli.eval_benchmark import evaluate as port_evaluate
from vlp3d_torch.cli.eval_benchmark import main as port_eval_main


def _tree(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            path = os.path.join(d, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = fh.read()
    return out


def _both(tmp_path, call):
    """``call(module, out_dir)`` for each package -> (JAX's files, the
    port's files)."""
    got = []
    for name, mod in (("jax", jax_vis), ("port", port_vis)):
        out = tmp_path / name
        out.mkdir()
        call(mod, str(out))
        got.append(_tree(str(out)))
    return got


def _corners(rng, k):
    from vlp3d_torch.eval.box_iou import get_3d_box

    return np.stack([get_3d_box(rng.uniform(0.2, 2, 3), rng.uniform(-3, 3),
                                rng.uniform(-4, 4, 3)) for _ in range(k)])


@pytest.mark.parametrize("rgb", [False, True])
def test_write_ply_points_is_jax_s(tmp_path, rgb):
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(57, 3)).astype(np.float32) * 3
    col = rng.integers(0, 256, (57, 3)).astype(np.uint8) if rgb else None
    want, got = _both(tmp_path, lambda m, d: m.write_ply_points(
        os.path.join(d, "p.ply"), xyz, col))
    assert got == want and len(want) == 1


def test_write_obj_boxes_is_jax_s(tmp_path):
    corners = _corners(np.random.default_rng(2), 5)
    want, got = _both(tmp_path, lambda m, d: m.write_obj_boxes(
        os.path.join(d, "b.obj"), corners))
    assert got == want


@pytest.mark.parametrize("color,gain", [((255, 0, 0), 5.0),
                                        ((0, 255, 0), 1.0),
                                        ((17, 200, 99), 2.5)])
def test_write_ply_box_heatmap_is_jax_s(tmp_path, color, gain):
    rng = np.random.default_rng(3)
    corners = _corners(rng, 7)
    weights = rng.uniform(0, 0.4, 7)
    want, got = _both(tmp_path, lambda m, d: m.write_ply_box_heatmap(
        os.path.join(d, "h.ply"), corners, weights, color=color, gain=gain))
    assert got == want


@pytest.mark.parametrize("head", [None, 1])
def test_save_bbox_heatmap_is_jax_s(tmp_path, head):
    rng = np.random.default_rng(4)
    corners = _corners(rng, 6)
    heatmap = rng.dirichlet(np.ones(6), size=(2, 3))  # (obj, heads, K)
    want, got = _both(tmp_path, lambda m, d: m.save_bbox_heatmap(
        os.path.join(d, "hm"), corners, heatmap, head=head))
    assert got == want
    assert len(want) == 2 * (3 if head is None else 1)


@pytest.mark.parametrize("boxes", ["none", "pred", "both"])
def test_dump_scene_is_jax_s(tmp_path, boxes):
    rng = np.random.default_rng(5)
    cloud = rng.normal(size=(40, 7)).astype(np.float32)
    color = rng.integers(0, 256, (40, 3))
    pred = _corners(rng, 2) if boxes != "none" else None
    gt = _corners(rng, 3) if boxes == "both" else None
    want, got = _both(tmp_path, lambda m, d: m.dump_scene(
        os.path.join(d, "s"), cloud, pred_corners=pred, gt_corners=gt,
        pcl_color=color if boxes == "both" else None))
    assert got == want


@pytest.mark.parametrize("inference,masked", [(False, False), (True, False),
                                              (False, True)])
def test_dump_detection_results_is_jax_s(tmp_path, inference, masked):
    rng = np.random.default_rng(6)
    b, k, k2 = 2, 12, 10
    outputs = {
        "pred_center": rng.uniform(0, 4, (b, k, 3)),
        "pred_size": rng.uniform(0.3, 1.0, (b, k, 3)),
        "pred_heading": rng.uniform(-1, 1, (b, k)),
        "objectness_scores": rng.normal(size=(b, k, 2)) * 3,
        "sem_cls_scores": rng.normal(size=(b, k, 4)),
        "objectness_label": (rng.uniform(size=(b, k)) < 0.5).astype(int),
    }
    batch = {"center_label": rng.uniform(0, 4, (b, k2, 3)),
             "box_label_mask": (rng.uniform(size=(b, k2)) < 0.7).astype(
                 np.float32)}
    mask = (rng.uniform(size=(b, k)) < 0.6).astype(int) if masked else None
    want, got = _both(tmp_path, lambda m, d: m.dump_detection_results(
        outputs, batch, d, pred_mask=mask, inference=inference))
    assert got == want
    assert any("pred_confident_nms_bbox" in f for f in want)
    assert inference == (not any("gt_centroid" in f for f in want))


def _bench_inputs(rng):
    from vlp3d_torch.eval.box_iou import get_3d_box

    preds, gts = [], {}
    for s in range(3):
        sid = f"scene{s:04d}_00"
        for o in range(4):
            for a in range(2):
                center = rng.uniform(-2, 2, 3)
                size = rng.uniform(0.5, 1.5, 3)
                gt = get_3d_box(size, 0.0, center)
                gts.setdefault(sid, {}).setdefault(str(o), {})[str(a)] = {
                    "bbox": gt.tolist()}
                shift = rng.normal(0, 0.3, 3)
                preds.append({
                    "scene_id": sid, "object_id": o, "ann_id": a,
                    "bbox": get_3d_box(size * rng.uniform(0.7, 1.3, 3), 0.0,
                                       center + shift).tolist(),
                    "unique_multiple": int(rng.integers(0, 2)),
                    "others": int(rng.integers(0, 2)),
                })
    # records the GTs do not hold: a scene, an object and an annotation
    preds.append(dict(preds[0], scene_id="scene0999_00"))
    preds.append(dict(preds[1], object_id=99))
    preds.append(dict(preds[2], ann_id=7))
    # one without the breakdown keys
    preds.append({k: v for k, v in preds[3].items()
                  if k not in ("unique_multiple", "others")})
    return preds, gts


def test_eval_benchmark_is_jax_s(tmp_path):
    preds, gts = _bench_inputs(np.random.default_rng(7))
    want = jax_evaluate(preds, gts)
    got = port_evaluate(preds, gts)
    assert got == want
    assert got["num_scored"] == len(preds) - 3
    assert 0.0 < got["overall_acc@0.25"] < 1.0
    p, g = tmp_path / "pred.json", tmp_path / "gt.json"
    p.write_text(json.dumps(preds))
    g.write_text(json.dumps(gts))
    argv = ["--pred", str(p), "--gt", str(g)]
    assert port_eval_main(argv) == jax_eval_main(argv) == want


def test_eval_benchmark_scores_pred_as_gt_at_one():
    """The check phase 18 makes on the card: GTs built from the records'
    own boxes give 1.0 at both thresholds."""
    preds, _ = _bench_inputs(np.random.default_rng(8))
    gts = {}
    for r in preds:
        gts.setdefault(r["scene_id"], {}).setdefault(
            str(r["object_id"]), {})[str(r["ann_id"])] = {"bbox": r["bbox"]}
    got = port_evaluate(preds, gts)
    assert got == jax_evaluate(preds, gts)
    assert got["overall_acc@0.25"] == got["overall_acc@0.5"] == 1.0
    assert got["num_scored"] == len(preds)


def test_postmortem_installs_the_jax_hook():
    """install() replaces sys.excepthook with a hook that prints the
    traceback through sys.__excepthook__ and, off a terminal, returns;
    both packages' hooks do the same."""
    import io

    saved = sys.excepthook
    try:
        import vlp3d.utils.postmortem as jax_pm
        import vlp3d_torch.utils.postmortem as port_pm

        outs = []
        for mod in (jax_pm, port_pm):
            sys.excepthook = saved
            mod.install()
            hook = sys.excepthook
            assert hook is not saved and hook.__module__ == mod.__name__
            err, stderr = io.StringIO(), sys.stderr
            sys.stderr = err
            try:
                try:
                    raise ValueError("boom")
                except ValueError:
                    hook(*sys.exc_info())
            finally:
                sys.stderr = stderr
            outs.append(err.getvalue().splitlines()[-1])
        assert outs[0] == outs[1] == "ValueError: boom"
    finally:
        sys.excepthook = saved
