"""Rank jobs of the pipeline and point-axis tests (no JAX here): each runs
in a gloo rank process started by tests/test_torch_distributed.py's
``run_ranks`` (``python tests/test_torch_distributed.py <job> <spec>
<out>``), reads its inputs from the spec's npz and returns arrays keyed
``<case>/<what>`` for the parent, which holds them against the JAX
package.
"""

import numpy as np
import torch


def _pipeline(spec: dict, shard) -> dict:
    """The pipelined BERT text layers on a grid of the ranks: the output
    of every case and its gradients (loss: the mean square of the
    output), the data group's average where a case has one; then the
    shapes that must raise."""
    from vlp3d_torch.models.bert import BertConfig, BertTextEncoder
    from vlp3d_torch.parallel.pipeline import (
        build_pipeline,
        pipeline_text_encoder,
        stage_range,
    )
    from vlp3d_torch.parallel.reduce import LOCAL
    from vlp3d_torch.parallel.tensor_parallel import make_grid

    cfg = BertConfig(**spec["cfg"])
    enc = BertTextEncoder(cfg, device="cpu")
    enc.load_state_dict(torch.load(spec["state"], weights_only=True),
                        strict=True)
    enc.eval()
    data = np.load(spec["npz"])
    ids = torch.from_numpy(data["ids"]).long()
    mask = torch.from_numpy(data["mask"])
    res = {}
    for case in spec["cases"]:
        name, pp, mb = case["name"], case["pp"], case["mb"]
        grid = make_grid(pp)
        dshard = grid.data if case["dp"] else LOCAL
        enc.zero_grad(set_to_none=True)
        out = pipeline_text_encoder(grid.model, enc, ids, mask,
                                    num_microbatches=mb, data=dshard)
        (out ** 2).mean().backward()
        res[f"{name}/out"] = out.detach().numpy()
        res[f"{name}/stage"] = np.asarray(grid.model.rank)
        lo, hi = stage_range(cfg.fusion_layer, grid.model.rank, pp)
        for n, p in enc.named_parameters():
            if p.grad is None:
                continue
            g = p.grad
            if dshard.distributed:  # the data axis's convention
                import torch.distributed as dist

                g = g.clone()
                dist.all_reduce(g, group=dshard.group)
                g /= dshard.world
            res[f"{name}/grad.{n}"] = g.numpy()
        res[f"{name}/layers"] = np.arange(lo, hi)
    # the shapes that must raise (JAX's messages)
    errors = []
    layers = list(enc.bert.encoder.layer)
    grid4, grid1 = make_grid(4), make_grid(1)
    x = enc.bert.embeddings(ids).detach()
    for what, call in [
            ("no group", lambda: pipeline_text_encoder(None, enc, ids, mask)),
            ("layers", lambda: build_pipeline(grid4.model, layers[:1], 6, 4)),
            ("microbatches",
             lambda: build_pipeline(grid4.model, layers[:1], 4, 3)(x, mask)),
            ("data-axis",
             lambda: build_pipeline(grid1.model, layers, 4, 4,
                                    grid1.data)(x, mask))]:
        try:
            call()
            errors.append(f"{what}: no error")
        except ValueError as e:
            errors.append(f"{what}: {e}")
    res["errors"] = np.asarray(errors)
    return res


def _points(spec: dict, shard) -> dict:
    """The point-sharded ops on point groups of 2 and 4 ranks (a grid of
    the ranks), each rank holding its slab of the clouds: FPS, the ball
    query, the gather and group with the group's backward (this rank's
    slab of the gradient), the front end and the backbone."""
    from vlp3d_torch.models.backbone import PointNet2Backbone
    from vlp3d_torch.parallel.point_parallel import (
        apply_backbone_large_scene,
        ball_query_sharded,
        fps_sharded,
        gather_points_sharded,
        group_points_sharded,
        large_scene_front,
    )
    from vlp3d_torch.parallel.tensor_parallel import make_grid

    data = np.load(spec["npz"])
    res = {}
    for w in spec["worlds"]:
        point = make_grid(w).model
        pre = f"w{w}/"

        def slab(a, point=point):
            n = a.shape[1] // point.world
            lo = point.rank * n
            return torch.from_numpy(np.ascontiguousarray(a[:, lo:lo + n]))

        xyz, feats = slab(data["xyz"]), slab(data["feats"])
        centers = torch.from_numpy(data["centers"])
        res[pre + "fps"] = fps_sharded(xyz, spec["npoint"], point).numpy()
        for i, (r, ns) in enumerate(spec["balls"]):
            res[pre + f"ball{i}"] = ball_query_sharded(
                r, ns, xyz, centers, point).numpy()
        res[pre + "gather"] = gather_points_sharded(
            feats, torch.from_numpy(data["idx2"]), point).numpy()
        table = feats.clone().requires_grad_(True)
        grouped = group_points_sharded(table, torch.from_numpy(data["idx3"]),
                                       point)
        grouped.backward(torch.from_numpy(data["up"]))
        res[pre + "group"] = grouped.detach().numpy()
        res[pre + "group_grad"] = table.grad.numpy()
        res[pre + "rank"] = np.asarray(point.rank)
        new_xyz, g, inds = large_scene_front(
            point, spec["npoint"], spec["radius"], spec["nsample"])(xyz, feats)
        res[pre + "front_new"] = new_xyz.numpy()
        res[pre + "front_grouped"] = g.numpy()
        res[pre + "front_inds"] = inds.numpy()
        bb = spec["backbone"]
        backbone = PointNet2Backbone(
            bb["input_feature_dim"], npoints=tuple(bb["npoints"]),
            radii=tuple(bb["radii"]), nsamples=tuple(bb["nsamples"]),
            device="cpu")
        backbone.load_state_dict(torch.load(bb["state"], weights_only=True),
                                 strict=True)
        backbone.eval()
        with torch.no_grad():
            out = apply_backbone_large_scene(
                backbone, slab(data["pc"]), point)
        for k, v in out.items():
            res[pre + "bb." + k] = v.numpy()
    return res


JOBS = {"pipeline": _pipeline, "points": _points}
