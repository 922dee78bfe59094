"""MLCVNet in vlp3d_torch against the JAX package, on the CPU: the CGNL
block, JointNet with ``use_mlcv_net`` in training, the same model on 2
gloo ranks (data parallel, ZeRO-1, tensor parallel) and the standalone
detector. Weights are seeded numpy fills in the flax models' shapes
(``tests/torch_task_steps.py``), nudged so that every loss is live,
carried over by ``vlp3d_torch.convert`` and loaded with ``strict=True``.
Stated tolerances:

  * SpatialCGNL: within 1e-4 (relative and absolute) of JAX's. ``att``
    sums the N x gc products p * g of a group in another order, and
    GroupNorm's E[x^2] - E[x]^2 is as exact as its two means;
  * the grouped 1x1 conv ``z``: the port's weight is the reference's
    ``Conv2d(planes, inplanes, 1, groups=4)`` layout, weight[g * og + o,
    c] = JAX's z_kernel[g, c, o], and ``F.conv2d(groups=4)`` with it
    gives the port's einsum within 1e-12 in float64;
  * GroupNorm against flax's ``GroupNorm(4, epsilon=1e-5)`` (its default
    fast variance): within 1e-5 on unit-scale inputs;
  * the JointNet train step (dropout off on both sides, the port
    following JAX's side of 0 at every ReLU input, within 1e-3 of 0 where
    they differ): the joint loss and every metric atol / rtol 1e-4, every
    gradient's median error within 1e-4 and every entry within 5e-3 of
    the tensor's largest entry, BatchNorm statistics atol 1e-5 / rtol
    1e-4 (tests/test_torch_train.py's);
  * the 2-rank steps against the one-process port step on the global
    batch (the port's seeded weights, nudged): the same, and the
    parameters after the update as tests/test_torch_train.py holds them
    (within 2e-5 where the two gradients agree in more than their first
    digit, 90% of the entries at least, and within 2.2 x lr everywhere);
  * the detector, in float64 on both sides (its test says why): the
    evaluation forward's indices and objectness masks equal, its floats
    within 1e-6; its step (the VoteNet detection loss) with the metrics
    within 1e-6, every gradient's median error within 1e-5 and every
    entry within 1e-4 of the tensor's largest entry, BatchNorm statistics
    within 1e-6 (relative) and 1e-8.

ROADMAP C20: JAX's ``export_jointnet_state_dict`` drops the CGNL block;
the port's converter carries it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_distributed import run_ranks
from test_torch_train import OPT
from torch_task_steps import (
    assert_flips_near_zero,
    assert_grads_match,
    assert_stats_match,
    drop_out,
    follow_kinks,
    jax_step,
    kink_names,
    no_dropout,
    seeded_variables,
    to_torch_batch,
)
from vlp3d.data.synthetic import make_batch as jax_make_batch
from vlp3d.data.synthetic import tiny_config as jax_tiny_config
from vlp3d.losses.joint import compute_joint_loss as jax_joint_loss
from vlp3d.losses.vqa import compute_vqa_loss as jax_vqa_loss
from vlp3d.models.jointnet import JointNet as JaxJointNet
from vlp3d.models.mlcvnet import SpatialCGNL as JaxCGNL
from vlp3d.models.mlcvnet_detector import MLCVNetDetector as JaxDetector
from vlp3d.models.torch_export import export_jointnet_state_dict
from vlp3d_torch import convert
from vlp3d_torch.data.synthetic import make_batch, tiny_config
from vlp3d_torch.losses.joint import compute_joint_loss
from vlp3d_torch.losses.vqa import compute_vqa_loss
from vlp3d_torch.models import JointNet
from vlp3d_torch.models.mlcvnet import (
    GroupNorm,
    MLCVVotingModule,
    SpatialCGNL,
)
from vlp3d_torch.models.mlcvnet_detector import MLCVNetDetector
from vlp3d_torch.models.voting import VotingModule
from vlp3d_torch.train import batch_to_device, make_optimizer, make_train_step
from vlp3d_torch.train.optimizer import label_params
from vlp3d_torch.train.schedules import cosine_lr

FLAGS = dict(use_con=False, no_caption=True, use_mlcv_net=True)
BATCH, POINTS = 4, 256
TOL = dict(rtol=1e-4, atol=1e-4)
# the detector in float64 on both sides: its gradients' median error and
# largest error, of each tensor's largest entry (floored at 1e-3). JAX's
# float64 run keeps some of its ops in float32 (its boxes agree with the
# port's to ~4e-9), which the CGNL's cancelling sums amplify: measured
# ~2e-6 (median) and ~2e-5 (largest)
GRAD64_MEDIAN, GRAD64_MAX = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cgnl_tree(rng, inplanes, planes, groups=4):
    gc = planes // groups
    return {
        **{n: {"kernel": rng.normal(0, inplanes ** -0.5, (inplanes, planes))
               .astype(np.float32)} for n in ("t", "p", "g")},
        "z_kernel": rng.normal(0, gc ** -0.5, (groups, gc, inplanes // groups))
        .astype(np.float32),
        "GroupNorm_0": {
            "scale": (1 + rng.normal(0, 0.1, inplanes)).astype(np.float32),
            "bias": rng.normal(0, 0.1, inplanes).astype(np.float32)},
    }


@pytest.mark.parametrize("inplanes,planes,n", [(256, 128, 40), (128, 64, 16)])
def test_cgnl_matches_jax_and_holds_the_grouped_conv_layout(inplanes, planes,
                                                             n):
    rng = np.random.default_rng(0)
    tree = _cgnl_tree(rng, inplanes, planes)
    x = rng.normal(0.5, 1.0, (2, n, inplanes)).astype(np.float32)
    want = np.asarray(JaxCGNL(inplanes, planes).apply({"params": tree}, x))
    sd = {}
    convert.convert_cgnl(tree, "", sd)
    port = SpatialCGNL(inplanes, planes, device="cpu")
    port.load_state_dict(convert.to_tensors(sd), strict=True)
    got = port(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **TOL)

    # the layout: the reference's grouped conv weight, row g * og + o of
    # group g reading that group's gc input channels
    zk, zw = tree["z_kernel"], port.z.weight.detach().numpy()
    groups, gc, og = zk.shape
    assert zw.shape == (inplanes, gc, 1, 1)
    for g in range(groups):
        for o in range(og):
            np.testing.assert_array_equal(zw[g * og + o, :, 0, 0], zk[g, :, o])
    # and it is the weight F.conv2d(groups=4) reads: the port's einsum
    # against the grouped conv on the same (att * t) values
    y = torch.from_numpy(rng.normal(size=(2, n, planes))).double()
    w = port.z.weight.detach().double()
    ein = torch.einsum("bngc,goc->bngo", y.reshape(2, n, groups, gc),
                       w.reshape(groups, og, gc)).reshape(2, n, inplanes)
    conv = F.conv2d(y.permute(0, 2, 1)[..., None], w, groups=groups)
    np.testing.assert_allclose(conv[..., 0].permute(0, 2, 1).numpy(),
                               ein.numpy(), rtol=0, atol=1e-12)


def test_group_norm_matches_flax_fast_variance():
    import flax.linen as fnn

    rng = np.random.default_rng(1)
    x = rng.normal(0.0, 1.0, (3, 50, 64)).astype(np.float32)
    scale = (1 + rng.normal(0, 0.1, 64)).astype(np.float32)
    bias = rng.normal(0, 0.1, 64).astype(np.float32)
    mod = fnn.GroupNorm(num_groups=4, epsilon=1e-5)
    want = np.asarray(mod.apply({"params": {"scale": scale, "bias": bias}},
                                x))
    port = GroupNorm(4, 64, device="cpu")
    port.load_state_dict({"weight": torch.from_numpy(scale),
                          "bias": torch.from_numpy(bias)})
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               want, rtol=1e-5, atol=1e-5)
    # a constant group: the fast variance rounds to <= 0 and is clamped
    const = torch.full((1, 7, 64), 3.3)
    assert torch.isfinite(port(const)).all()


def _batch(seed=17, batch_size=BATCH):
    b = jax_make_batch(jax_tiny_config(**FLAGS), batch_size=batch_size,
                       num_points=POINTS, seed=seed)
    b["random"] = np.float32(0.7)
    return b


def _nudge(params):
    """Votes near their seeds and ~0.7 m boxes, so that every loss is
    live (tests/test_torch_train.py's nudges)."""
    for leaf in params["vgen"]["Dense_2"].values():
        leaf *= 0.05
    params["proposal"]["roi_heads"]["Dense_3"]["bias"][:] = -1.0


@pytest.fixture(scope="module")
def jointnet_side():
    mp = no_dropout()
    try:
        config = jax_tiny_config(**FLAGS)
        model = JaxJointNet(config)
        batch = _batch()
        shapes = jax.eval_shape(lambda b: model.init(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, b,
            train=True), batch)
        params, stats = seeded_variables(shapes, seed=3)
        _nudge(params)
        result = jax_step(model, lambda o, b: jax_joint_loss(config, o, b),
                          params, stats, batch)
    finally:
        mp.undo()
    return dict(params=params, stats=stats, batch=batch, result=result,
                sd=convert.jax_to_torch_state_dict(params, stats),
                kinks=kink_names(convert.jax_to_torch_state_dict, params,
                                 stats, result[3]))


def _port_jointnet(sd):
    model = JointNet(tiny_config(**FLAGS), device="cpu")
    model.load_state_dict(sd, strict=True)
    return model


def test_mlcv_jointnet_builds_the_cgnl_voting(jointnet_side):
    model = _port_jointnet(jointnet_side["sd"])
    assert isinstance(model.vgen, MLCVVotingModule)
    assert {k for k in jointnet_side["sd"] if k.startswith("vgen.sa1.")} == {
        "vgen.sa1.t.weight", "vgen.sa1.p.weight", "vgen.sa1.g.weight",
        "vgen.sa1.z.weight", "vgen.sa1.gn.weight", "vgen.sa1.gn.bias"}
    plain = JointNet(tiny_config(**dict(FLAGS, use_mlcv_net=False)),
                     device="cpu")
    assert type(plain.vgen) is VotingModule


def test_mlcv_eval_forward_matches_jax(jointnet_side):
    want = jointnet_side["result"][4]
    got = _port_jointnet(jointnet_side["sd"])(
        to_torch_batch(jointnet_side["batch"]))
    for k in ("sa1_inds", "aggregated_vote_inds", "objectness_masks"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("vote_xyz", "vote_features", "cluster_ref", "pred_center",
              "pred_size", "bbox_feature"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)


def test_mlcv_train_step_matches_jax(jointnet_side):
    jmetrics, jgrads, jstats, _, _ = jointnet_side["result"]
    config = tiny_config(**FLAGS)
    model = _port_jointnet(jointnet_side["sd"])
    drop_out(model)
    batch = to_torch_batch(jointnet_side["batch"])
    metrics = {}

    def run():
        loss, m = compute_joint_loss(config, model(batch, train=True), batch)
        loss.backward()
        metrics.update(m)

    assert_flips_near_zero(follow_kinks(model, jointnet_side["kinks"], run))
    for k, want in jmetrics.items():
        np.testing.assert_allclose(metrics[k].detach().numpy(),
                                   np.asarray(want), err_msg=k, **TOL)
    for k in ("ref_loss", "vote_loss", "box_loss", "objectness_loss"):
        assert float(metrics[k].detach()) > 0, k
    held = assert_grads_match(model, convert.jax_to_torch_state_dict(
        jgrads, jointnet_side["stats"]), "mlcv jointnet")
    # p and g are held too, but their gradient is rounding noise (the
    # GroupNorm after the block cancels att's scale: only eps / att^2 of
    # it reaches them), under the 1e-3 floor on both sides
    assert {"vgen.sa1.t.weight", "vgen.sa1.z.weight",
            "vgen.sa1.gn.weight"} <= set(held)
    assert_stats_match(model, convert.jax_to_torch_state_dict(
        jointnet_side["params"], jstats))


def _save_batch(path, batch):
    np.savez(path, **{k: np.asarray(v) for k, v in batch.items()})
    return str(path)


def test_mlcv_parallel_steps_match_one_process(tmp_path):
    """2 gloo ranks: data parallel (the MLCV BatchNorms on global
    statistics), ZeRO-1 and tp 2 x dp 1, each one step against the
    one-process port step on the global batch: both ranks' states equal
    bit for bit; the metrics, gradients, BatchNorm statistics and the
    parameters after the update at this file's tolerances."""
    flags = dict(FLAGS, use_con=True)
    config = tiny_config(**flags)
    model = JointNet(config, device="cpu")  # seeded weights, nudged
    with torch.no_grad():
        model.vgen.conv3.weight.mul_(0.05)
        model.vgen.conv3.bias.mul_(0.05)
        model.proposal.proposal.box_predictor.bias.fill_(-1.0)
    state = tmp_path / "state.pt"
    torch.save(model.state_dict(), state)
    batch = make_batch(config, batch_size=BATCH, num_points=POINTS, seed=17)
    batch["random"] = np.float32(0.7)
    path = _save_batch(tmp_path / "b.npz", batch)
    runs = [dict(name=name, state=str(state), flags=flags, dropout=False,
                 seed=0, opt=OPT, batches=[path], **extra)
            for name, extra in (("dp", {}), ("zero1", {"zero1": True}),
                                ("tp", {"tp": 2}))]
    res = run_ranks("steps", {"runs": runs}, tmp_path)

    drop_out(model)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, lr_schedule=lambda e, lr0: cosine_lr(
        e, lr0, 200), **OPT)
    wmetrics = make_train_step(model, config, opt)(
        batch_to_device(batch, "cpu"), torch.Generator().manual_seed(0))
    for k in ("vote_loss", "objectness_loss", "box_loss", "lang_loss"):
        assert float(wmetrics[k]) > 0, k
    want_sd = model.state_dict()
    wgrads = {n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
              for n, p in model.named_parameters()}
    for name, _ in ((r["name"], r) for r in runs):
        pre = f"{name}/"
        keys = [k for k in res[0] if k.startswith(pre)]
        assert keys and keys == [k for k in res[1] if k.startswith(pre)]
        for k in keys:
            np.testing.assert_array_equal(res[0][k], res[1][k], err_msg=k)
        got = JointNet(config, device="cpu")
        after = dict(before)
        after.update({k[len(pre) + 6:]: torch.from_numpy(v)
                      for k, v in res[0].items()
                      if k.startswith(pre + "param.")})
        after.update({k[len(pre) + 4:]: torch.from_numpy(v)
                      for k, v in res[0].items()
                      if k.startswith(pre + "buf.")})
        got.load_state_dict(after, strict=True)
        for n, p in got.named_parameters():
            g = res[0].get(f"{pre}grad.{n}")
            p.grad = None if g is None else torch.from_numpy(g)
        for k, v in res[0].items():
            if k.startswith(pre + "metric0."):
                np.testing.assert_allclose(
                    v, wmetrics[k[len(pre) + 8:]].numpy(), err_msg=k, **TOL)
        held = assert_grads_match(got, wgrads, name)
        assert "vgen.sa1.t.weight" in held
        assert_stats_match(got, want_sd)
        # tests/test_torch_train.py's rule for the parameters after Adam's
        # first update: within 2e-5 where the gradients agree in more than
        # their first digit (90% of the entries at least), 2.2 x lr anywhere
        lr = {"base": OPT["base_lr"], "module": OPT["module_lr"]}
        labels = label_params(got)
        firm_n = total_n = 0
        for n, p in got.named_parameters():
            diff = (p.detach() - want_sd[n]).abs()
            if labels[n] == "frozen":
                assert not diff.any(), n
                continue
            assert float(diff.max()) <= 2.2 * lr[labels[n]], (name, n)
            wg = wgrads[n]
            gg = torch.zeros_like(wg) if p.grad is None else p.grad
            err = (gg - wg).abs()
            firm = (wg.abs() >= torch.clamp(20 * err, min=1e-7)) | (
                (wg == 0) & (gg == 0))
            if bool(firm.any()):
                assert float(diff[firm].max()) <= 2e-5, (name, n)
            firm_n += int(firm.sum())
            total_n += firm.numel()
        assert firm_n >= 0.9 * total_n, (name, firm_n, total_n)


def _f64(a):
    a = np.asarray(a)
    return a.astype(np.float64) if a.dtype == np.float32 else a


@pytest.fixture(scope="module")
def detector_side():
    """The JAX detector's evaluation forward and train step (the VoteNet
    detection loss), in float64."""
    config = jax_tiny_config(**FLAGS)
    model = JaxDetector(config)
    batch = _batch(seed=21)
    shapes = jax.eval_shape(lambda b: model.init(
        {"params": jax.random.key(0)}, b, train=True), batch)
    params, stats = seeded_variables(shapes, seed=4)
    for leaf in params["vgen"]["Dense_2"].values():
        leaf *= 0.05
    mp = no_dropout()
    try:
        with jax.enable_x64(True):
            params = jax.tree_util.tree_map(_f64, params)
            stats = jax.tree_util.tree_map(_f64, stats)
            batch = {k: _f64(v) for k, v in batch.items()}
            mean = jnp.asarray(config.dataset.mean_size_arr(), jnp.float64)

            def loss(o, b):
                return jax_vqa_loss(o, b, mean, use_reference=False,
                                    use_lang_classifier=False,
                                    use_answer=False)

            result = jax_step(model, loss, params, stats, batch)
    finally:
        mp.undo()
    return dict(params=params, stats=stats, batch=batch, result=result,
                kinks=kink_names(convert.mlcvnet_detector_to_torch_state_dict,
                                 params, stats, result[3]))


def _port_detector(side):
    model = MLCVNetDetector(tiny_config(**FLAGS), device="cpu").double()
    model.load_state_dict(convert.mlcvnet_detector_to_torch_state_dict(
        side["params"], side["stats"]), strict=True)
    return model


def test_detector_eval_forward_matches_jax(detector_side):
    want = detector_side["result"][4]
    got = _port_detector(detector_side)(to_torch_batch(detector_side["batch"]))
    assert set(want) <= set(got), set(want) - set(got)
    for k in ("sa1_inds", "aggregated_vote_inds", "objectness_masks"):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k])), k
    for k in ("vote_xyz", "aggregated_vote_features", "objectness_scores",
              "center", "size_residuals", "pred_size", "sem_cls_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_detector_train_step_matches_jax(detector_side):
    """In float64: in float32 the CGNL blocks' p and g gradients, and
    everything below the blocks, pass through one scalar a scene and
    group, dL / d att, a sum of N x gc terms that cancel; its float32
    error reaches 1e-3 of the backbone's gradients (measured), which
    would hide a wrong formula as small as that."""
    jmetrics, jgrads, jstats, _, _ = detector_side["result"]
    config = tiny_config(**FLAGS)
    model = _port_detector(detector_side)
    batch = to_torch_batch(detector_side["batch"])
    mean = torch.from_numpy(config.dataset.mean_size_arr()).double()
    metrics = {}

    def run():
        loss, m = compute_vqa_loss(model(batch, train=True), batch, mean,
                                   use_reference=False,
                                   use_lang_classifier=False,
                                   use_answer=False)
        loss.backward()
        metrics.update(m)

    assert_flips_near_zero(follow_kinks(model, detector_side["kinks"], run))
    for k, want in jmetrics.items():
        np.testing.assert_allclose(metrics[k].detach().numpy(),
                                   np.asarray(want), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for k in ("vote_loss", "objectness_loss", "box_loss"):
        assert float(metrics[k].detach()) > 0, k
    want_grads = convert.mlcvnet_detector_to_torch_state_dict(
        jgrads, detector_side["stats"])
    for name, p in model.named_parameters():
        want = want_grads[name].numpy()
        err = np.abs(p.grad.numpy() - want)
        scale = max(float(np.abs(want).max()), 1e-3)
        assert np.median(err) <= GRAD64_MEDIAN * scale, name
        assert err.max() <= GRAD64_MAX * scale, name
    want_sd = convert.mlcvnet_detector_to_torch_state_dict(
        detector_side["params"], jstats)
    for name, buf in model.named_buffers():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want_sd[name].numpy(),
                                       rtol=1e-6, atol=1e-8, err_msg=name)


def test_c20_jax_export_drops_the_cgnl_the_port_carries_it(jointnet_side):
    """ROADMAP.md C20: export_jointnet_state_dict writes only vgen's
    Dense_0-2 and BatchNorm_0-1, so an MLCV tree exported by the JAX
    package loses its CGNL block (silently: nothing raises). The port's
    converter carries it, and the port refuses the JAX export strictly."""
    params, stats = jointnet_side["params"], jointnet_side["stats"]
    exported = export_jointnet_state_dict(params, stats)
    assert not [k for k in exported if k.startswith("vgen.sa1.")]
    port = JointNet(tiny_config(**FLAGS), device="cpu")
    missing, _ = port.load_state_dict(
        {k: torch.from_numpy(np.array(v)) for k, v in exported.items()},
        strict=False)
    assert {k for k in missing if k.startswith("vgen.")} == {
        "vgen.sa1.t.weight", "vgen.sa1.p.weight", "vgen.sa1.g.weight",
        "vgen.sa1.z.weight", "vgen.sa1.gn.weight", "vgen.sa1.gn.bias"}
    assert set(port.state_dict()) == set(jointnet_side["sd"])


def test_cli_train_predict_and_serve_take_use_mlcv_net(tmp_path):
    """``--use_mlcv_net`` through the CLIs on the CPU: train_3dvlp trains
    the CGNL model (--smoke keeps the model flags), predict reads its
    snapshot strictly and writes a record an annotation, and the server
    builds on it and answers a request as its predictor does."""
    import json
    import shutil

    from vlp3d_torch.cli import predict as predict_cli
    from vlp3d_torch.cli import serve as serve_cli
    from vlp3d_torch.cli import train_3dvlp
    from vlp3d_torch.train import checkpoint as ckpt

    flags = ["--synthetic", "--smoke", "--no_caption", "--device", "cpu",
             "--num_workers", "1", "--use_mlcv_net", "--use_con"]
    try:
        train_3dvlp.main(flags + ["--coslr", "--num_scenes", "2",
                                  "--workdir", str(tmp_path / "run")])
        with open(tmp_path / "run" / "log.jsonl") as f:
            records = [json.loads(line) for line in f]
        train = [r for r in records if r["phase"] == "train"]
        assert train and all(np.isfinite(r["loss"]) and r["vote_loss"] > 0
                             for r in train)
        sd = ckpt.load_params(str(tmp_path / "run"), "model")
        assert "vgen.sa1.z.weight" in sd
        out = str(tmp_path / "pred.json")
        preds = predict_cli.main(flags + ["--model_dir", str(tmp_path / "run"),
                                          "--out", out])
        assert preds and json.load(open(out)) == preds
        args, tasks = serve_cli.parse_args(
            flags[1:] + ["--port", "0", "--model_dir", str(tmp_path / "run"),
                         "--serve_batch_size", "2", "--no_warmup"])
        server, services = serve_cli.build_server(args, tasks)
        try:
            service = services["ground"]
            assert isinstance(service._pred.model.vgen, MLCVVotingModule)
            rng = np.random.default_rng(0)
            cloud = rng.uniform(-1, 1, (service.num_points, 3)).astype(
                np.float32)
            reply = service.handle(
                {"point_cloud": cloud.tolist(), "queries": ["the chair"]})
            (box,) = reply["boxes"]
            assert np.isfinite(box["center"]).all()
        finally:
            server.server_close()
            for s in services.values():
                s.close()
    finally:
        shutil.rmtree(tmp_path, ignore_errors=True)
