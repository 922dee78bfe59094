"""ZeRO-1 of vlp3d_torch (``vlp3d_torch.parallel.zero``) against the JAX
package's ``vlp3d.parallel.zero``, and against the port's data-parallel
step.

  * the moment layout: which elements of each trained parameter's
    moments every rank of an ``n_data`` x ``n_model`` grid holds, against
    JAX's ``opt_state_pspecs`` (with ``param_pspecs`` under TP) carried
    into the port's layout through ``vlp3d_torch.convert`` (a spec
    computation, no step);
  * the step on 2 gloo ranks (tests/test_torch_distributed.py's ``steps``
    job) bit for bit against the port's data-parallel step on the same
    ranks and batch (parameters, gradients, buffers, metrics and whole
    moments: the update is elementwise); the ZeRO-1 step against JAX's
    step on the global batch is in tests/test_torch_tensor_parallel.py's
    launch, beside the TP steps, so that one JAX compile serves them all;
  * ``train_qa --zero1 --tp 2`` on 2 ranks, whose checkpoint loads
    ``strict=True`` into a one-process Solver.
"""

import dataclasses
import json
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_ddp import _save_batch
from test_torch_distributed import (
    RANK_TIMEOUT,
    free_port,
    launch,
    rank_env,
    run_ranks,
)
from test_torch_train import FLAGS, OPT, _batch
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.parallel.tensor_parallel import param_pspecs
from vlp3d.parallel.zero import MIN_SHARD_ELEMS as JAX_MIN_SHARD_ELEMS
from vlp3d.parallel.zero import opt_state_pspecs
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.models import JointNet
from vlp3d_torch.parallel.zero import MIN_SHARD_ELEMS, moment_layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every module with TP layers (the caption and MLM decoders' feed-forwards)
SPEC_FLAGS = dict(use_con=True, no_caption=False, use_mlm=True)
# the set-abstraction modules' first-layer weights (SA1-4 and the vote
# aggregation): JAX's first_xyz and first_feat kernels joined into one
# tensor, which takes one split (ROADMAP.md C15)
JOINED = "mlp_module.layer0.conv.weight"


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.fixture(scope="module")
def jax_tree():
    """Shapes of the tiny JointNet's params and batch stats (no init
    compile; a training init, which builds the MLM head)."""
    config = jax_tiny_config(**SPEC_FLAGS)
    batch = make_batch(tiny_config(**SPEC_FLAGS), batch_size=1,
                       num_points=256)
    v = jax.eval_shape(lambda: JaxJointNet(config).init(
        {"params": jax.random.key(0), "dropout": jax.random.key(1),
         "aug": jax.random.key(2)}, batch, train=True))
    return v["params"], v["batch_stats"]


def _owned(shape, parts) -> np.ndarray:
    """A float mask of ``shape``: 1 on the block that ``parts`` (dim ->
    (index, count)) selects."""
    mask = np.zeros(shape, np.float32)
    sl = [slice(None)] * len(shape)
    for dim, (i, n) in parts.items():
        size = shape[dim] // n
        sl[dim] = slice(i * size, (i + 1) * size)
    mask[tuple(sl)] = 1.0
    return mask


def _jax_masks(tree, n_data, n_model, d, m) -> dict:
    """Rank (d, m)'s moment elements of every JAX parameter, as masks in
    the port's layout (through convert)."""
    params, stats = tree
    tp = param_pspecs(params, n_model) if n_model > 1 else None
    # an optax state's moment paths end with the whole parameter path
    specs = opt_state_pspecs({"mu": params}, n_data, params=params,
                             param_specs=tp)["mu"]
    index = {"data": (d, n_data), "model": (m, n_model)}

    def mask(leaf, spec):
        return _owned(leaf.shape, {dim: index[axis]
                                   for dim, axis in enumerate(spec)
                                   if axis is not None})

    masks = jax.tree.map(mask, params, specs,
                         is_leaf=lambda x: isinstance(x, P))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), stats)
    return jax_to_torch_state_dict(masks, zeros)


def test_min_shard_elems_is_jax_s():
    assert MIN_SHARD_ELEMS == JAX_MIN_SHARD_ELEMS


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (4, 1), (2, 2), (4, 2)])
def test_moment_slices_match_jax_opt_state_pspecs(jax_tree, n_data, n_model):
    """The first and last ranks of each axis of the grid hold the same
    elements of each trained parameter's moments as under JAX's specs;
    the joined SA first-layer
    weights (C15) are the one difference, and the moments split over the
    data group hold most of the bytes."""
    model = JointNet(tiny_config(**SPEC_FLAGS), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    layout = moment_layout(model, n_data, n_model)
    assert layout and all(n in shapes for n in layout)
    split = [n for n, (_, dd) in layout.items() if dd is not None]
    assert sum(np.prod(shapes[n]) for n in split) > 0.5 * sum(
        np.prod(shapes[n]) for n in layout)
    if n_model > 1:
        assert any(t is not None for t, _ in layout.values())
    # the first and the last rank of each axis (a split's first and last
    # part)
    for d in sorted({0, n_data - 1}):
        for m in sorted({0, n_model - 1}):
            want = _jax_masks(jax_tree, n_data, n_model, d, m)
            for name, (tp_dim, data_dim) in layout.items():
                if name.endswith(JOINED):
                    continue
                parts = {}
                if tp_dim is not None:
                    parts[tp_dim] = (m, n_model)
                got = _owned(shapes[name], parts)
                if data_dim is not None:
                    got[...] = 0.0
                    sl = [slice(None)] * len(shapes[name])
                    if tp_dim is not None:
                        w = shapes[name][tp_dim] // n_model
                        sl[tp_dim] = slice(m * w, (m + 1) * w)
                    w = shapes[name][data_dim] // n_data
                    sl[data_dim] = slice(d * w, (d + 1) * w)
                    got[tuple(sl)] = 1.0
                np.testing.assert_array_equal(
                    got, np.asarray(want[name]),
                    err_msg=f"{name} rank ({d}, {m})")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The data-parallel and the ZeRO-1 step on 2 gloo ranks from one
    seeded state, one launch."""
    tmp = tmp_path_factory.mktemp("zero")
    state = tmp / "state.pt"
    torch.manual_seed(0)
    torch.save(JointNet(tiny_config(**FLAGS), device="cpu").state_dict(),
               state)
    batch = [_save_batch(tmp / "b0.npz", _batch(0, 0.7))]
    base = dict(state=str(state), flags=FLAGS, dropout=False, seed=0,
                opt=OPT, batches=batch)
    runs = [dict(base, name="dp", moments=True),
            dict(base, name="zero", zero1=True)]
    res = run_ranks("steps", {"runs": runs}, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


def test_zero1_step_is_the_data_parallel_step_bit_for_bit(ranks):
    """Parameters, gradients, buffers, metrics and the whole moments of
    the ZeRO-1 step equal the data-parallel step's on the same ranks and
    batch; each rank holds about half of the moment bytes."""
    for r in ranks:
        dp = {k[3:]: v for k, v in r.items() if k.startswith("dp/")}
        zero = {k[5:]: v for k, v in r.items() if k.startswith("zero/")}
        keys = set(dp) - {"state_bytes"}
        assert keys == set(zero) - {"state_bytes"}
        assert sum(k.startswith("moment.") for k in keys) > 100
        for k in keys:
            np.testing.assert_array_equal(zero[k], dp[k], err_msg=k)
        assert 0.45 < int(zero["state_bytes"]) / int(dp["state_bytes"]) < 0.6


def test_zero1_checkpoint_of_train_qa_loads_into_one_process(tmp_path):
    """``train_qa --zero1 --tp 2`` on 2 ranks (a data group of one, a model
    group of two): its snapshot loads strictly into a one-process model
    and its resume checkpoint into a one-process Solver, whose moments
    then have their parameters' shapes."""
    from vlp3d_torch.train import checkpoint as ckpt
    from vlp3d_torch.train.solver import Solver

    workdir = tmp_path / "run"
    port = free_port()
    argv = [sys.executable, "-m", "vlp3d_torch.cli.train_qa", "--synthetic",
            "--smoke", "--device", "cpu", "--num_workers", "1",
            "--workdir", str(workdir), "--zero1", "--tp", "2"]
    launch([argv] * 2, [rank_env(r, 2, port) for r in range(2)],
           RANK_TIMEOUT, cwd=REPO)
    with open(workdir / "info.json") as f:
        info = json.load(f)
    assert info["args"]["zero1"] and info["args"]["tp"] == 2
    config = tiny_config(use_con=False)  # train_qa's flags
    config = dataclasses.replace(
        config, model=dataclasses.replace(
            config.model, num_answers=info["num_answers"], use_answer=True,
            no_caption=True),
        train=dataclasses.replace(config.train, batch_size=2, epochs=1,
                                  optim_name="adam", single_lr_group=True))
    model = JointNet(config, device="cpu")
    model.load_state_dict(ckpt.load_params(str(workdir), "model"),
                          strict=True)
    ds = _qa_dataset(config)
    solver = Solver(config, ds, ds, str(tmp_path / "one"), device="cpu")
    try:
        solver.init_state()
        meta = ckpt.load_checkpoint(str(workdir), solver.model,
                                    solver.optimizer)
        assert meta["epoch"] == 1
        n = 0
        for p, st in solver.optimizer.state.items():
            assert st["mu"].shape == p.shape == st["nu"].shape
            n += 1
        assert n > 100
    finally:
        solver.close()


def _qa_dataset(config):
    from vlp3d_torch.data.synthetic import make_synthetic_dataset

    return make_synthetic_dataset(config, n_scenes=1, anns_per_scene=2)
