"""The new CLIs' model loading and device choice, on the CPU:
``validate``'s (and the visualizers') ``--model_dir`` loads as far as it
goes (ROADMAP C26), and each CLI that builds a model raises without
CUDA unless ``--device`` is given.
"""

import argparse
import shutil

import pytest
import torch

from vlp3d_torch.cli import (
    caption_visualize,
    ground_visualize,
    heatmap_visualize,
    import_torch,
    validate,
)
from vlp3d_torch.data.synthetic import tiny_config
from vlp3d_torch.models.jointnet import JointNet
from vlp3d_torch.train.checkpoint import save_params


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test writes a ~130 MB snapshot (BERT's 30522-word embedding);
    remove it after the test."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def test_model_dir_is_a_warm_start(tmp_path):
    """--model_dir's entries replace the check model's; a head the
    snapshot lacks keeps its seeded values, and one the model lacks is
    ignored."""
    snap = JointNet(tiny_config(use_con=True, no_caption=True), device="cpu")
    for p in snap.parameters():
        p.data.add_(1.0)
    save_params(str(tmp_path), "model", snap.state_dict())
    args = argparse.Namespace(model_dir=str(tmp_path), device="cpu")
    model, weights = validate._model(args, tiny_config(use_con=False,
                                                       no_caption=False))
    own = model.state_dict()
    fresh = JointNet(tiny_config(use_con=False, no_caption=False),
                     device="cpu").state_dict()
    taken = [k for k in own if k in snap.state_dict()]
    ignored = [k for k in snap.state_dict() if k not in own]
    assert ignored and all(k.startswith("constrast.") for k in ignored)
    assert weights == {"restored": len(taken),
                       "fresh": len(own) - len(taken),
                       "ignored": len(ignored)}
    assert any(k.startswith("caption.") for k in own if k not in taken)
    for k in own:
        want = snap.state_dict()[k] if k in taken else fresh[k]
        assert torch.equal(own[k], want), k


def _reference_pth(tmp_path):
    path = str(tmp_path / "ref.pth")
    torch.save(JointNet(tiny_config(), device="cpu").state_dict(), path)
    return path


@pytest.mark.parametrize("cli", ["ground_visualize", "heatmap_visualize",
                                 "caption_visualize", "validate",
                                 "import_torch"])
def test_new_clis_run_on_the_card_unless_asked(cli, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = {
        "validate": ["--out", str(tmp_path / "r.json")],
        "import_torch": ["--checkpoint", _reference_pth(tmp_path), "--out",
                         str(tmp_path / "o"), "--fusion_layer", "2"],
    }.get(cli, ["--synthetic", "--smoke", "--out_dir", str(tmp_path / "v")])
    main = {"ground_visualize": ground_visualize.main,
            "heatmap_visualize": heatmap_visualize.main,
            "caption_visualize": caption_visualize.main,
            "validate": validate.main, "import_torch": import_torch.main}[cli]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
