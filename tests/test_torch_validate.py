"""The port's validation runbook on stand-in assets, on the CPU (its
``--model_dir`` load and the new CLIs' refusal to run without a card
unless asked: ``test_torch_cli_devices.py``).

``python -m vlp3d_torch.cli.validate --synthetic_standins DIR
--num_points 512 --num_proposals 16 --device cpu`` reaches ``ok`` in
every check (``torch_import_chain`` runs ``import_torch`` as a process
of its own); ``bert_weight_import``'s config and unconsumed keys are
those of JAX's ``check_bert_weight_import`` on the same directory; a
stale scene cache flips ``scene_cache`` to ``fail`` with exit code 1, as
``tests/test_validate_cli.py`` checks for JAX. JAX's whole runbook is
not run here (its own test is marked slow).
"""

import argparse
import json
import shutil
import sys

import numpy as np
import pytest
import torch

from vlp3d.cli.validate import check_bert_weight_import
from vlp3d_torch.cli import validate
from vlp3d_torch.data.standins import write_scene_assets

CHECKS = ("tokenizer_golden", "bert_weight_import", "scene_cache",
          "predict_contract", "grounding_acc", "caption_smoke", "vqa_smoke",
          "multiview_hdf5", "torch_import_chain")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test writes snapshots of ~130-450 MB (BERT's 30522-word
    embedding); remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_validate_on_standins_every_check_ok(tmp_path):
    out = tmp_path / "report.json"
    root = tmp_path / "standins"
    rc = validate.main(["--synthetic_standins", str(root), "--num_points",
                        "512", "--num_proposals", "16", "--device", "cpu",
                        "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 0, report
    assert report["ok"] and set(report["checks"]) == set(CHECKS)
    for name in CHECKS:
        assert report["checks"][name]["status"] == "ok", (
            name, report["checks"][name])
    want = check_bert_weight_import(argparse.Namespace(
        bert_dir=str(root / "bert")))
    got = report["checks"]["bert_weight_import"]
    assert got["config"] == want["config"]
    assert got["unconsumed_keys"] == want["unconsumed_keys"]
    assert abs(got["cls_norm"] - want["cls_norm"]) <= 1e-4 * want["cls_norm"]
    pred = json.loads(open(report["checks"]["predict_contract"]
                           ["pred_json"]).read())
    assert len(pred) == 3 and set(pred[0]) == {
        "scene_id", "object_id", "ann_id", "bbox", "unique_multiple",
        "others"}
    assert np.asarray(pred[0]["bbox"]).shape == (8, 3)
    assert report["checks"]["grounding_acc"]["n"] == 3
    for v in report["checks"]["caption_smoke"]["metrics"].values():
        assert np.isfinite(v)
    assert report["checks"]["vqa_smoke"]["questions"] == 3
    mv = report["checks"]["multiview_hdf5"]
    assert mv["bit_identical_to_baked"] and mv["item_channels"] == 135
    chain = report["checks"]["torch_import_chain"]
    assert chain["pred_finite"] and chain["probe_leaf"] == validate.PROBE
    assert "kept" in chain["import_stdout"][0]


def test_validate_fails_on_stale_cache(tmp_path):
    data = tmp_path / "scannet_data"
    data.mkdir()
    write_scene_assets(str(data), np.random.default_rng(9), stale=True)
    out = tmp_path / "report.json"
    rc = validate.main(["--scannet_data", str(data), "--device", "cpu",
                        "--out", str(out)])
    report = json.loads(out.read_text())
    assert rc == 1 and not report["ok"]
    assert report["checks"]["scene_cache"]["status"] == "fail"
    assert "stale preprocess cache" in report["checks"]["scene_cache"][
        "error"]


def test_validate_skips_without_assets(tmp_path):
    out = tmp_path / "report.json"
    assert validate.main(["--device", "cpu", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert set(report["checks"]) == set(CHECKS)
    assert all(c["status"] == "skipped" for c in report["checks"].values())


def test_tokenizer_golden_skips_without_transformers(tmp_path, monkeypatch):
    """The card's machine has no transformers: the golden check is
    skipped with JAX's "no HF oracle" reason, after its round trip."""
    from vlp3d_torch.data.standins import write_bert_vocab

    write_bert_vocab(str(tmp_path))
    monkeypatch.setitem(sys.modules, "transformers", None)
    got = validate.check_tokenizer_golden(argparse.Namespace(
        bert_dir=str(tmp_path)))
    assert got["status"] == "skipped"
    assert got["reason"].startswith("no HF oracle")
