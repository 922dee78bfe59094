"""Helpers of the single-task model tests (test_torch_scanqa.py,
test_torch_refnet.py, test_torch_capnet.py): seeded flax weights in a
model's shapes, one jitted JAX train step that also returns its
gradients and the inputs of every ReLU, and the port's step held to
tests/test_torch_train.py's tolerances while it follows JAX's side of 0
at each ReLU input (test_torch_train_qa.py's ``_follow_jax_kinks``).
"""

from __future__ import annotations

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_train_qa import FLIP_TOL, _kink_input
from vlp3d_torch.models.layers import Dropout

# the captioner's ReLU inputs (a Dense whose output a ReLU reads)
CAPTION_RELU = ("map_previous", "obj_fc")


def kink_input(mdl, method_name):
    """``_kink_input`` plus the top-down captioner's ReLU inputs."""
    return _kink_input(mdl, method_name) or (
        isinstance(mdl, fnn.Dense) and mdl.name in CAPTION_RELU)


def seeded_variables(shapes, seed: int = 1):
    """(params, batch_stats) in the shapes of ``jax.eval_shape`` of a
    model's init: fan-in-scaled normal kernels, small biases, scales near
    1, random BatchNorm statistics (tests/test_torch_train_qa.py's fill)."""
    rng = np.random.default_rng(seed)

    def param(path, a):
        name = path[-1].key
        if name in ("scale", "negative_slope") or (
                name == "weight" and len(a.shape) == 1):
            return (1.0 + rng.normal(0.0, 0.05, a.shape)).astype(np.float32)
        if name == "bias" or len(a.shape) < 2:
            return rng.normal(0.0, 0.01, a.shape).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1]))
        return rng.normal(0.0, fan_in ** -0.5, a.shape).astype(np.float32)

    def stat(path, a):
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(param, shapes["params"])
    stats = jax.tree_util.tree_map_with_path(stat, shapes["batch_stats"])
    return params, stats


def no_dropout():
    """A MonkeyPatch with flax's Dropout the identity (undo it after
    tracing the JAX functions)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(fnn.Dropout, "__call__",
               lambda self, inputs, deterministic=None, rng=None: inputs)
    return mp


def jax_step(model, loss, params, stats, batch):
    """One jitted JAX train forward + backward: (metrics, gradients, new
    batch statistics, captured ReLU inputs) of ``loss(outputs, batch) ->
    (loss, metrics)``, and the evaluation forward's outputs."""

    def loss_fn(p, b):
        out, upd = model.apply(
            {"params": p, "batch_stats": stats}, b, train=True,
            rngs={"dropout": jax.random.key(0)},
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=kink_input)
        value, m = loss(out, b)
        scalars = {k: v for k, v in m.items() if jnp.ndim(v) == 0}
        return value, (scalars, upd["batch_stats"], upd["intermediates"])

    @jax.jit
    def run(b):
        grads, (metrics, new_stats, kinks) = jax.grad(
            loss_fn, has_aux=True)(params, b)
        evaluated = model.apply({"params": params, "batch_stats": stats}, b,
                                train=False)
        return metrics, grads, new_stats, kinks, evaluated

    return jax.device_get(run(batch))


def kink_names(convert, params, stats, kinks):
    """{port module name: [the JAX module's captured output of each call]}
    for every ReLU input: a BatchNorm is found by its running mean and a
    feed-forward's first linear by its bias (each JAX one marked with a
    distinct constant, ``convert`` says where it lands), the relation
    module's distance MLP and the captioner's linears by name."""
    paths = []

    def mark(path, a):
        keys = tuple(k.key for k in path)
        if keys[-1] != "mean" and keys[-3:] != ("ffn", "Dense_0", "bias"):
            return a
        paths.append(keys[:-1])
        return np.full(a.shape, len(paths), np.float32)

    marked = convert(jax.tree_util.tree_map_with_path(mark, params),
                     jax.tree_util.tree_map_with_path(mark, stats))
    out = {}
    for key, v in marked.items():
        for leaf in (".running_mean", ".ffn.linear1.bias"):
            if key.endswith(leaf):
                node = kinks
                for k in paths[int(v.reshape(-1)[0]) - 1]:
                    node = node[k]
                out[key[:-len(leaf.rpartition(".")[2]) - 1]] = node[
                    "__call__"]
    for name, node in kinks.get("relation", {}).items():
        if name.startswith("attn_fc"):
            i, j = name.removeprefix("attn_fc").split("_")
            out[f"relation.self_attn_fc.{i}.{(0, 3)[int(j)]}"] = node[
                "__call__"]
    cap = kinks.get("caption", {})
    if "map_previous" in cap:  # once a word in both packages
        out["caption.map_previous"] = cap["map_previous"]["__call__"]
    if "obj_fc" in cap:
        # the JAX step recomputes the proposal features' linear every word
        # (the same value); the port computes it once
        out["caption.obj_fc"] = cap["obj_fc"]["__call__"][:1]
    return out


def follow_kinks(model, names, run):
    """Run ``run()`` with every ReLU input of the port on JAX's side of 0
    (test_torch_train_qa.py's ``_follow_jax_kinks``, call by call: the
    k-th call of a module follows JAX's k-th, as the captioner's step
    calls its linears once a word). Returns {module: (units moved,
    largest |input| of such a unit on either side)}."""
    mods = dict(model.named_modules())
    flips, hooks, seen = {}, [], {}

    def follow(mod, args, out, name):
        k = seen.get(name, 0)
        seen[name] = k + 1
        want = torch.from_numpy(np.array(names[name][k]))
        flipped = (out > 0) != (want > 0)
        if not bool(flipped.any()):
            return None
        units, near = flips.get(name, (0, 0.0))
        flips[name] = (units + int(flipped.sum()), max(near, float(
            torch.maximum(out.detach()[flipped].abs(),
                          want[flipped].abs()).max())))
        return out + torch.where(flipped, want - out.detach(), 0.0)

    for name in names:
        hooks.append(mods[name].register_forward_hook(
            lambda m, a, o, name=name: follow(m, a, o, name)))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    assert all(seen.get(n, 0) == len(v) for n, v in names.items()), seen
    return flips


def drop_out(model):
    for m in model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


# biases that only a training-mode BatchNorm reads
BN_FED_BIASES = ("vgen.conv1.bias", "vgen.conv2.bias",
                 "proposal.proposal.convs.0.bias",
                 "proposal.proposal.convs.3.bias",
                 "relation.features_concat.0.bias")


def assert_grads_match(model, want_grads: dict, what: str = ""):
    """Every parameter's gradient: median error within 1e-4 and every
    entry within 5e-3 of the tensor's largest entry (floored at 1e-3;
    tests/test_torch_train.py). A gradient that is zero in exact
    arithmetic (rounding noise below 1e-6 on both sides: a softmax
    logit's or a key projection's bias) is skipped, and a bias that only
    a training-mode BatchNorm reads must be noise below 1e-5 on both
    sides. Returns the names held."""
    held = []
    for name, p in model.named_parameters():
        wg = want_grads[name].numpy()
        got = np.zeros_like(wg) if p.grad is None else p.grad.numpy()
        if np.abs(wg).max() < 1e-6 and np.abs(got).max() < 1e-6:
            continue
        if name.endswith(BN_FED_BIASES):
            # zero by construction (BatchNorm in training subtracts the
            # batch mean): rounding noise on both sides
            assert max(np.abs(wg).max(), np.abs(got).max()) <= 1e-5, name
            continue
        err = np.abs(got - wg)
        scale = max(float(np.abs(wg).max()), 1e-3)
        assert np.median(err) <= 1e-4 * scale, (
            f"{what} grad {name}", float(np.median(err)), scale)
        assert err.max() <= 5e-3 * scale, (
            f"{what} grad {name}", float(err.max()), scale)
        held.append(name)
    return held


def assert_flips_near_zero(flips):
    for name, (_, near) in flips.items():
        assert near <= FLIP_TOL, (name, near)


def assert_stats_match(model, want_sd: dict):
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def to_torch_batch(batch: dict) -> dict:
    return {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}


def three_updates(model, opt, tx):
    """3 updates of seeded gradients (N(0, 2): about a third above a clip
    at 1) through the port's optimizer ``opt`` and the optax chain ``tx``
    from the model's parameters: every parameter within 1e-6 after."""
    rng = np.random.default_rng(8)
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in model.named_parameters()}
    state = tx.init(params)
    update = jax.jit(tx.update)
    for _ in range(3):
        grads = {n: (2.0 * rng.normal(size=p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        updates, state = update(
            {n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        opt.step()
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
