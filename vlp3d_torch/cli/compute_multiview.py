"""Multiview feature extraction and projection, ENet on the card.

Counterpart of ``vlp3d/cli/compute_multiview.py`` (the reference's
``scripts/multiview_compute/compute_multiview_features.py`` +
``project_multiview_features.py --maxpool``): ENet
(:class:`~vlp3d_torch.models.enet.ENetEncoder`) over every sampled video
frame of each scene, ``FRAMES_PER_LAUNCH`` frames a launch, the feature maps
projected onto the scene's points through each frame's depth and pose,
the max over frames, and one (N, 128) dataset a scene in
``enet_feats_maxpool.hdf5``, the file ``--multiview_hdf5`` reads,
written by :mod:`vlp3d_torch.data.hdf5` (no ``h5py`` needed). The
projection, the max-pool and ``--labels`` (per-point majority vote of
the frames' label maps, ``<scene>_multiview_labels.npy`` and a PLY) are
the JAX CLI's numpy (:mod:`vlp3d_torch.data.multiview`).

    python -m vlp3d_torch.cli.compute_multiview --frames_dir FRAMES \\
        --scannet_data SCANNET [--out enet_feats_maxpool.hdf5] \\
        [--enet_checkpoint ENET.pth] [--device cpu]

Layout under ``--frames_dir``: ``<scene_id>/color/<frame>.npy`` (H, W, 3)
RGB, float or uint8 (divided by 255 when its largest value is above 2),
``<scene_id>/depth/<frame>.npy`` (H, W) metres,
``<scene_id>/pose/<frame>.txt`` the 4x4 camera-to-world matrix (and
``label/<frame>.npy`` for ``--labels``); the points are the first three
columns of ``--scannet_data``'s ``<scene_id>_aligned_vert.npy``.

``--enet_checkpoint`` reads a ``.pth`` state dict in this port's layout or
in the reference's ``create_enet`` layout
(:func:`~vlp3d_torch.models.enet.load_enet_reference_state_dict`).
Without one the weights are seeded from a numpy generator
(``ENET_SEED``); the JAX CLI takes flax's ``init`` of key 0 instead, so the
two packages' unseeded runs write different features (ROADMAP C21).
The convolutions run in float32 (cuDNN's TF32 off).
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from vlp3d_torch.data.hdf5 import DatasetWriter
from vlp3d_torch.data.multiview import (
    ProjectionHelper,
    maxpool_multiview_features,
    vote_multiview_labels,
)
from vlp3d_torch.device import resolve_device
from vlp3d_torch.models.enet import ENetEncoder, load_enet_reference_state_dict
from vlp3d_torch.models.jointnet import init_weights_

FRAMES_PER_LAUNCH = 16  # frames of one shape in one ENet call
ENET_SEED = 0  # the seeded weights without --enet_checkpoint (ROADMAP C21)

def load_enet(checkpoint: str | None, device) -> ENetEncoder:
    """The encoder on ``device`` with ``checkpoint``'s weights (this port's
    layout, or the reference's read by position), or seeded ones."""
    model = ENetEncoder(device=device)
    if not checkpoint:
        init_weights_(model, ENET_SEED)
        return model
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if set(sd) != set(model.state_dict()):
        sd = load_enet_reference_state_dict(sd)
    model.load_state_dict(sd, strict=True)
    return model


def frame_input(rgb: np.ndarray) -> np.ndarray:
    """One frame as ENet reads it: float32, scaled to [0, 1] when its
    largest value is above 2 (a uint8 frame)."""
    x = np.asarray(rgb, np.float32)
    return x / 255.0 if x.max() > 2.0 else x


@torch.no_grad()
def feature_maps(model: ENetEncoder, frames: list, device) -> list:
    """ENet over ``frames`` ((H, W, 3) arrays), up to ``FRAMES_PER_LAUNCH``
    frames of one shape a call -> one (H / 8, W / 8, 128) float32 array a
    frame."""
    out = []
    i = 0
    while i < len(frames):
        j = i + 1
        while (j < len(frames) and j - i < FRAMES_PER_LAUNCH
               and frames[j].shape == frames[i].shape):
            j += 1
        x = torch.from_numpy(np.stack([frame_input(f) for f in frames[i:j]]))
        out.extend(model(x.to(device)).cpu().numpy())
        i = j
    return out


def _frame_ids(sdir: str, sub: str, max_frames: int) -> list:
    ids = sorted(os.path.splitext(os.path.basename(f))[0]
                 for f in glob.glob(os.path.join(sdir, sub, "*.npy")))
    return ids[:max_frames] if max_frames else ids


def _projector(args, h: int, w: int, full_h: int, full_w: int):
    """The intrinsics scaled to the (h, w) map: the reference resizes the
    depth to the feature map (project_multiview_features.py:71-77)."""
    sx, sy = w / full_w, h / full_h
    intr = np.array([[args.fx * sx, 0, args.cx * sx],
                     [0, args.fy * sy, args.cy * sy], [0, 0, 1]], np.float32)
    return ProjectionHelper(intrinsics=intr, image_dims=(w, h))


def _depth_at(depth: np.ndarray, h: int, w: int) -> np.ndarray:
    return depth[:: depth.shape[0] // h or 1,
                 :: depth.shape[1] // w or 1][:h, :w]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--frames_dir", required=True)
    p.add_argument("--scannet_data", required=True)
    p.add_argument("--out", default="enet_feats_maxpool.hdf5")
    p.add_argument("--enet_checkpoint", default="")
    p.add_argument("--max_frames", type=int, default=0)
    p.add_argument("--labels", action="store_true",
                   help="project per-frame nyu40 label maps "
                        "(<scene>/label/<frame>.npy) with per-point "
                        "majority voting instead of features, writing "
                        "<scene>_multiview_labels.npy next to --out plus a "
                        "colored PLY (project_multiview_labels.py)")
    p.add_argument("--num_labels", type=int, default=41)
    # depth-camera intrinsics at the ORIGINAL frame resolution (ScanNet
    # defaults, project_multiview_features.py); scaled to feature res
    p.add_argument("--fx", type=float, default=577.870605)
    p.add_argument("--fy", type=float, default=577.870605)
    p.add_argument("--cx", type=float, default=319.5)
    p.add_argument("--cy", type=float, default=239.5)
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA device)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    scenes = sorted(d for d in os.listdir(args.frames_dir)
                    if os.path.isdir(os.path.join(args.frames_dir, d)))
    if args.labels:
        return _project_labels(args, scenes)

    device = resolve_device(args.device)
    torch.backends.cudnn.allow_tf32 = False
    model = load_enet(args.enet_checkpoint or None, device)
    with DatasetWriter(args.out) as out:
        for scene in scenes:
            sdir = os.path.join(args.frames_dir, scene)
            ids = _frame_ids(sdir, "color", args.max_frames)
            if not ids:
                continue
            points = np.load(os.path.join(
                args.scannet_data, f"{scene}_aligned_vert.npy"))[:, :3]
            rgbs = [np.load(os.path.join(sdir, "color", f"{fid}.npy"))
                    for fid in ids]
            maps = feature_maps(model, rgbs, device)
            frames, projector = [], None
            for fid, rgb, fmap in zip(ids, rgbs, maps):
                depth = np.load(os.path.join(sdir, "depth", f"{fid}.npy"))
                pose = np.loadtxt(os.path.join(sdir, "pose", f"{fid}.txt"))
                h, w = fmap.shape[:2]
                if projector is None:
                    projector = _projector(args, h, w, *rgb.shape[:2])
                frames.append((fmap, _depth_at(depth, h, w), pose))
            mv = maxpool_multiview_features(points, frames, projector)
            out.add(scene, mv)
            print(f"{scene}: {len(frames)} frames -> {mv.shape}")
    print(f"wrote {args.out}")
    return args.out


def _project_labels(args, scenes):
    """--labels: majority-voted per-point semantic labels and a
    label-colored PLY per scene (project_multiview_labels.py:148-178)."""
    from vlp3d_torch.utils.visualize import write_ply_points

    out_dir = os.path.dirname(os.path.abspath(args.out)) or "."
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(0)
    palette = rng.integers(0, 255, size=(args.num_labels, 3))
    palette[0] = 0  # unannotated -> black
    written = []
    for scene in scenes:
        sdir = os.path.join(args.frames_dir, scene)
        ids = _frame_ids(sdir, "label", args.max_frames)
        points = np.load(os.path.join(
            args.scannet_data, f"{scene}_aligned_vert.npy"))[:, :3]
        frames, projector = [], None
        for fid in ids:
            label = np.load(os.path.join(sdir, "label", f"{fid}.npy"))
            depth = np.load(os.path.join(sdir, "depth", f"{fid}.npy"))
            pose = np.loadtxt(os.path.join(sdir, "pose", f"{fid}.txt"))
            h, w = label.shape[:2]
            if projector is None:
                projector = _projector(args, h, w, depth.shape[0] or h,
                                       depth.shape[1] or w)
            frames.append((label, _depth_at(depth, h, w), pose))
        if not frames:
            continue
        labels = vote_multiview_labels(points, frames,
                                       num_labels=args.num_labels,
                                       projector=projector)
        npy_path = os.path.join(out_dir, f"{scene}_multiview_labels.npy")
        np.save(npy_path, labels.astype(np.int64))
        write_ply_points(
            os.path.join(out_dir, f"{scene}_multiview_labels.ply"),
            points, palette[labels])
        written.append(npy_path)
        print(f"{scene}: {len(frames)} frames -> labels {labels.shape}")
    print(f"wrote {len(written)} label files under {out_dir}")
    return written


if __name__ == "__main__":
    main()
