"""The caption visualizer CLI of the port against the JAX package's, on
the CPU.

``vlp3d.cli.caption_visualize.main(["--synthetic", "--smoke", ...])``
runs the JAX model from its seeded train state (recorded where the CLI
builds it, then converted into the port's snapshot), and the port's CLI
runs over the same synthetic val split with ``--model_dir``: the same
files (the kept proposals and their classes), every box vertex within
1e-4, the colours equal, and ``captions.json`` equal. HashTokenizer ids
agree only within one process, so both CLIs run here.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from test_torch_ground_visualize import (
    ARGS,
    assert_same_dumps,
    files,
    run_jax_cli,
)
from vlp3d.cli.caption_visualize import main as jax_caption
from vlp3d_torch.cli.caption_visualize import class_color
from vlp3d_torch.cli.caption_visualize import main as port_caption


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


def test_caption_visualize_matches_the_jax_cli(tmp_path, monkeypatch):
    model_dir = str(tmp_path / "run")
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    # --no_caption is overridden by both: the CLI exists to caption
    argv = ARGS + ["--no_caption", "--max_scenes", "2"]
    n_jax = run_jax_cli(jax_caption, argv + ["--out_dir", jax_dir],
                        model_dir, monkeypatch)
    n_port = port_caption(argv + ["--out_dir", port_dir, "--model_dir",
                                  model_dir, "--device", "cpu"])
    assert n_port == n_jax == 2
    want = files(jax_dir)
    assert files(port_dir) == want
    # the two rows of the first batch are chunks of one scene: the
    # second's captions.json replaces the first's, the boxes add up
    caps = [f for f in want if f.endswith("captions.json")]
    assert caps
    for rel in caps:
        got = json.load(open(os.path.join(port_dir, rel)))
        assert got == json.load(open(os.path.join(jax_dir, rel)))
        assert got and all(set(v) == {"object_name", "description"}
                           for v in got.values())
        boxes = [f for f in want if os.path.dirname(f) == os.path.dirname(
            rel) and os.path.basename(f).startswith("pred-")]
        assert len(boxes) >= len(got)
        for d in (jax_dir, port_dir):
            os.remove(os.path.join(d, rel))
    assert assert_same_dumps(jax_dir, port_dir) == len(want) - len(caps)


def test_class_colours_are_the_jax_cli_s():
    for cls in (0, 1, 13, 17):
        want = tuple(int(v) for v in np.random.default_rng(cls)
                     .integers(64, 255, 3))
        assert class_color(cls) == want


def test_caption_visualize_runs_on_a_grounding_snapshot_c26(tmp_path,
                                                            capsys):
    """ROADMAP C26: JAX's CLI reads ``state.params["caption"]``
    (``vlp3d/cli/caption_visualize.py:102``), which a snapshot trained
    with --no_caption lacks. The port loads --model_dir as far as it
    goes: the decoder keeps its seeded values, the count is printed, and
    the dumps are written."""
    from vlp3d_torch.cli.common import resolve_config
    from vlp3d_torch.cli.visualize_common import parse_visualizer_args
    from vlp3d_torch.models.jointnet import JointNet
    from vlp3d_torch.train.checkpoint import save_params

    args = parse_visualizer_args(ARGS + ["--no_caption"], "vis", 1)
    snap = JointNet(resolve_config(args), device="cpu").state_dict()
    assert not any(k.startswith("caption.") for k in snap)
    save_params(str(tmp_path / "run"), "model", snap)
    out = str(tmp_path / "vis")
    assert port_caption(ARGS + ["--no_caption", "--max_scenes", "1",
                                "--out_dir", out, "--model_dir",
                                str(tmp_path / "run"), "--device",
                                "cpu"]) == 1
    printed = capsys.readouterr().out
    fresh = int(printed.split(" fresh")[0].split()[-1])
    assert fresh > 0 and f"{len(snap)} entries restored" in printed
    assert any(f.endswith("captions.json") for f in files(out))
