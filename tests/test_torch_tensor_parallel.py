"""Tensor parallel of vlp3d_torch (``vlp3d_torch.parallel.tensor_parallel``)
against the JAX package's ``vlp3d.parallel.tensor_parallel``.

  * the parameter set: the parameters the port splits, and along which
    dimension, against JAX's ``param_pspecs`` carried into the port's
    layout through ``vlp3d_torch.convert`` (as tests/test_tp_coverage.py
    holds JAX's own), the fallback to replication where the size does not
    divide, and the one difference, attention whose heads do not divide
    (ROADMAP.md C14);
  * the step on 4 gloo ranks in one launch (tests/test_torch_distributed.py's
    ``steps`` job): ZeRO-1 (dp 2), tp 2 x dp 2 and ZeRO-1 x tp 2 x dp 2
    against JAX's step on the global batch at
    tests/test_torch_train.py's tolerances, every rank holding the same
    whole state bit for bit (the replicated parameters' gradients are
    equal across the model group),
    and tp 2 x dp 2 with dropout, box masks and MLM token masks (the MLM
    decoder's split feed-forwards and their dropout) against the port's
    one-process step from the same generator seed;
  * ``train_3dvlp --tp 2 --zero1`` on 2 ranks, whose snapshot loads
    ``strict=True`` into a one-process model and whose checkpoint into a
    one-process Solver, and a global batch that the data size does not
    divide.
"""

import dataclasses
import os
import re
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_ddp import (
    DRAW_FLAGS,
    _one_process,
    _rank_model,
    _ranks_agree,
    _records,
    _save_batch,
    _with_mlm_head,
)
from test_torch_distributed import (
    RANK_TIMEOUT,
    free_port,
    launch,
    rank_env,
    run_ranks,
)
from test_torch_train import (
    BATCH,
    FLAGS,
    OPT,
    _batch,
    assert_step_matches,
    jax_reference,
)
from test_torch_zero import SPEC_FLAGS, jax_tree  # noqa: F401  (fixture)
from vlp3d.parallel.tensor_parallel import param_pspecs
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.parallel.tensor_parallel import param_dims

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD4 = 4
# the JAX cases: (name, tp, zero1, dp); ZeRO-1 alone runs two data groups
# of 2 side by side (tests/test_torch_ddp.py's data size: at 4 the sums'
# order moves gradients that are rounding noise past the step's bounds)
JAX_RUNS = [("zero1", 1, True, 2), ("tp2", 2, False, 2),
            ("zero1_tp2", 2, True, 2)]
BERT_ATTENTION = re.compile(
    r".*\.encoder\.layer\.\d+\.attention\.(self\.(query|key|value)|"
    r"output\.dense)\.")


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


def _first_part_masks(tree, n_model) -> dict:
    """Model rank 0's part of every JAX parameter under ``param_pspecs``
    (1 on the part, 0 elsewhere), in the port's layout."""
    params, stats = tree
    specs = param_pspecs(params, n_model)

    def mask(leaf, spec):
        m = np.ones(leaf.shape, np.float32)
        for dim, axis in enumerate(spec):
            if axis is not None:
                sl = [slice(None)] * len(leaf.shape)
                sl[dim] = slice(leaf.shape[dim] // n_model, None)
                m[tuple(sl)] = 0.0
        return m

    masks = jax.tree.map(mask, params, specs,
                         is_leaf=lambda x: isinstance(x, P))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), stats)
    return jax_to_torch_state_dict(masks, zeros)


@pytest.mark.parametrize("n_model", [2, 7, 8])
def test_tp_parameter_set_is_jax_s(jax_tree, n_model):
    """The port splits the parameters JAX's rules split, along the same
    dimension; 7 divides nothing, so nothing splits (JAX's fallback); at 8
    the 12 BERT heads do not divide and the port keeps the attention
    whole where JAX splits its 768 columns (C14)."""
    model = JointNet(tiny_config(**SPEC_FLAGS), device="cpu")
    dims = param_dims(model, n_model)
    want = _first_part_masks(jax_tree, n_model)
    n_split = 0
    for name, p in model.named_parameters():
        got = np.ones(p.shape, np.float32)
        if name in dims:
            sl = [slice(None)] * p.dim()
            sl[dims[name]] = slice(p.shape[dims[name]] // n_model, None)
            got[tuple(sl)] = 0.0
            n_split += 1
        w = np.asarray(want[name])
        if (n_model == 8 and BERT_ATTENTION.match(name + ".")
                and (w == 0).any()):
            assert name not in dims, name  # C14: JAX splits, the port not
            continue
        np.testing.assert_array_equal(got, w, err_msg=name)
    bert = 2 * 10  # the tiny model's 2 text layers: 4 x 2 + 2 column, 2 row
    decoders = 2 * 6 * 3  # caption and MLM: 6 layers of w_1 (2) + w_2 (1)
    match = 2 * 3  # two cross-attention feed-forwards
    assert n_split == {2: bert + decoders + match, 7: 0,
                       8: 2 * 3 + decoders + match}[n_model]


@pytest.fixture(scope="module")
def jax_side():
    """The JAX fixture of tests/test_torch_train.py with JAX's step on the
    one global batch of every case: one traced program."""
    side = jax_reference(batches=[_batch(0, 0.7)], warm=(),
                         evaluate_too=False)
    jparams, jstats, jmetrics, jgrads = side["results"][0]
    side["want"] = (jmetrics, jax_to_torch_state_dict(jgrads, jstats),
                    jax_to_torch_state_dict(jparams, jstats))
    return side


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Every tensor-parallel step of this file on 4 gloo ranks, one
    launch."""
    tmp = tmp_path_factory.mktemp("tp")
    state = tmp / "jax_state.pt"
    torch.save(jax_side["sd"], state)
    batch = [_save_batch(tmp / "b0.npz", _batch(0, 0.7))]
    runs = [dict(name=name, state=str(state), flags=FLAGS, dropout=False,
                 seed=0, opt=OPT, batches=batch, tp=tp, zero1=zero1, dp=dp)
            for name, tp, zero1, dp in JAX_RUNS]
    draw_state = tmp / "draw_state.pt"
    torch.save(_with_mlm_head(jax_side["sd"]), draw_state)
    draw_batch = make_batch(tiny_config(**DRAW_FLAGS), batch_size=BATCH,
                            num_points=256, seed=17, epoch=60)
    draw_batch["random"] = np.float32(0.3)
    runs.append(dict(name="draws", state=str(draw_state), flags=DRAW_FLAGS,
                     dropout=True, seed=11, opt=OPT, tp=2,
                     batches=[_save_batch(tmp / "draws.npz", draw_batch)]))
    res = run_ranks("steps", {"runs": runs,
                              "bad_batch": dict(tp=2, batch_size=3)},
                    tmp, world=WORLD4)
    sd = torch.load(draw_state, weights_only=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return dict(res=res, draw=(sd, draw_batch))


def _all_ranks_agree(res, name):
    for r in range(1, len(res)):
        _ranks_agree([res[0], res[r]], name)


@pytest.mark.parametrize("name", [r[0] for r in JAX_RUNS])
def test_tp_step_matches_jax_on_the_global_batch(jax_side, ranks, name):
    jmetrics, jgrads, jafter = jax_side["want"]
    _all_ranks_agree(ranks["res"], name)
    config = tiny_config(**FLAGS)
    model, metrics = _rank_model(ranks["res"], name, jax_side["sd"], config)
    assert_step_matches(model, jax_side["sd"], metrics, jmetrics, jgrads,
                        jafter, 0)


def test_tp_step_with_dropout_and_masks_matches_one_process(ranks):
    """The split feed-forwards' and BERT attention's dropout draw their
    masks at the whole layer's shape and keep their part: the tp 2 x dp 2
    step equals the one-process port step from the same seed."""
    sd, draw_batch = ranks["draw"]
    config, want, wmetrics, wgrads = _one_process(
        sd, DRAW_FLAGS, [draw_batch], 11, OPT, dropout=True)
    assert float(wmetrics[0]["mlm_loss"]) > 0
    _all_ranks_agree(ranks["res"], "draws")
    model, metrics = _rank_model(ranks["res"], "draws", sd, config)
    before = {k: v.clone() for k, v in sd.items()}
    assert_step_matches(model, before, metrics,
                        {k: v.numpy() for k, v in wmetrics[0].items()},
                        wgrads, want.state_dict(), 60)


def test_batch_the_data_size_does_not_divide_names_the_sizes(ranks):
    for r in ranks["res"]:
        msg = str(r["bad_batch"])
        assert "global batch 3 not divisible by 2" in msg, msg
        assert "world 4 / tp 2" in msg, msg


def test_train_3dvlp_tp_zero1_on_two_ranks_checkpoints_whole(tmp_path):
    """``train_3dvlp --tp 2 --zero1`` on 2 ranks (tp 2, a data group of
    one): finite losses; its snapshot loads strictly into a one-process
    model and its checkpoint into a one-process Solver, whose moments have
    their parameters' shapes."""
    from vlp3d_torch.train import checkpoint as ckpt
    from vlp3d_torch.train.solver import Solver

    workdir = tmp_path / "run"
    port = free_port()
    argv = [sys.executable, "-m", "vlp3d_torch.cli.train_3dvlp",
            "--synthetic", "--smoke", "--device", "cpu", "--num_workers",
            "1", "--no_caption", "--use_con", "--batch_size", "2",
            "--workdir", str(workdir), "--tp", "2", "--zero1"]
    results = launch([argv] * 2, [rank_env(r, 2, port) for r in range(2)],
                     RANK_TIMEOUT, cwd=REPO)
    assert "distributed init (rank 0/2)" in results[0][1]
    recs = _records(str(workdir))
    train = [r for r in recs if r["phase"] == "train"]
    assert train and all(np.isfinite(r["loss"]) for r in train)
    config = tiny_config(no_caption=True, use_con=True)
    config = dataclasses.replace(config, train=dataclasses.replace(
        config.train, batch_size=2, epochs=1))
    model = JointNet(config, device="cpu")
    model.load_state_dict(ckpt.load_params(str(workdir), "model_last"),
                          strict=True)
    from vlp3d_torch.data.synthetic import make_synthetic_dataset

    ds = make_synthetic_dataset(config, n_scenes=1, anns_per_scene=2)
    solver = Solver(config, ds, ds, str(tmp_path / "one"), device="cpu")
    try:
        solver.init_state()
        ckpt.load_checkpoint(str(workdir), solver.model, solver.optimizer)
        states = list(solver.optimizer.state.items())
        assert len(states) > 100
        for p, st in states:
            assert st["mu"].shape == p.shape == st["nu"].shape
    finally:
        solver.close()
