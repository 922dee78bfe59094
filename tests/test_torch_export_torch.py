"""``export_torch`` of the port against the JAX package's ``export_torch``
CLI, on the CPU: on the default smoke model (caption decoder on, no
contrast head) both write the same keys and bits, with and without
``--base`` (which carries the reference's extra keys through) and
``--dp_prefix``. The seeded weights and helpers are
``test_torch_weights_io.py``'s.
"""

import shutil

import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_weights_io import assert_equal_dicts, weights  # noqa: F401
from vlp3d.cli.export_torch import main as jax_export_main
from vlp3d.train import checkpoint as jax_ckpt
from vlp3d_torch.cli import export_torch
from vlp3d_torch.convert import jax_to_torch_state_dict
from vlp3d_torch.train.checkpoint import save_params


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _free_disk(tmp_path):
    """Each test writes snapshots of ~130 MB (BERT's 30522-word
    embedding); remove them after it."""
    yield
    shutil.rmtree(tmp_path, ignore_errors=True)


@pytest.mark.parametrize("base,dp", [(False, False), (True, True)])
def test_export_torch_is_jax_s(tmp_path, base, dp, weights):
    """The default smoke model (caption decoder on, no contrast head):
    JAX's CLI on its orbax snapshot and the port's on the converted
    snapshot write the same keys and bits; --base carries the reference's
    extra keys through in both."""
    params, stats, ref, _ = weights("default")
    jdir, pdir = str(tmp_path / "jax_run"), str(tmp_path / "port_run")
    jax_ckpt.save_params(jdir, "model", jax.tree_util.tree_map(
        jnp.asarray, params), jax.tree_util.tree_map(jnp.asarray, stats))
    jax_ckpt.wait_until_finished()
    save_params(pdir, "model", jax_to_torch_state_dict(params, stats))
    extra = []
    if base:
        base_path = str(tmp_path / "base.pth")
        torch.save(ref, base_path)
        extra = ["--base", base_path]
    if dp:
        extra.append("--dp_prefix")
    jax_out, port_out = str(tmp_path / "jax.pth"), str(tmp_path / "port.pth")
    jax_export_main(["--model_dir", jdir, "--out", jax_out] + extra)
    export_torch.main(["--model_dir", pdir, "--out", port_out] + extra)
    want, got = torch.load(jax_out), torch.load(port_out)
    assert_equal_dicts(got, want)
    assert any(".src_attn." in k for k in got)
    assert base == any(".cls." in k for k in got)
    assert all(k.startswith("module.") for k in got) == dp
