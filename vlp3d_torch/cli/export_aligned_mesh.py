"""Axis-aligned mesh / scene-dump utilities: the port's counterpart of
``vlp3d/cli/export_aligned_mesh.py``.

Two subcommands covering the reference's small scene tooling:

  * ``mesh`` — read each scan's `_vh_clean_2.ply` + the axisAlignment
    matrix from its meta txt and write an axis-aligned PLY mesh
    (scripts/captioning_scripts/export_scannet_axis_aligned_mesh.py);
  * ``verts`` — dump an exported scene's `_vert.npy` /
    `_aligned_vert.npy` as OBJ point files (data/scannet/visualize.py).

Usage:
  python -m vlp3d_torch.cli.export_aligned_mesh mesh \
      --scans_dir scans/ --out_dir aligned_mesh/ [--scene_id scene0000_00]
  python -m vlp3d_torch.cli.export_aligned_mesh verts \
      --scannet_data scannet_data/ --scene_id scene0000_00
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def export_aligned_mesh(scans_dir: str, scene_id: str, out_dir: str) -> str:
    from vlp3d_torch.data.scannet import (
        align_vertices,
        read_axis_align_matrix,
        read_mesh_vertices_rgb,
        read_ply_faces,
        write_ply_mesh,
    )

    sdir = os.path.join(scans_dir, scene_id)
    mesh_path = os.path.join(sdir, f"{scene_id}_vh_clean_2.ply")
    meta_path = os.path.join(sdir, f"{scene_id}.txt")
    vertices = read_mesh_vertices_rgb(mesh_path)
    faces = read_ply_faces(mesh_path)
    axis_align = read_axis_align_matrix(meta_path)
    if axis_align is not None:
        vertices = align_vertices(vertices, axis_align)
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{scene_id}.ply")
    write_ply_mesh(out_path, vertices, faces)
    return out_path


def dump_scene_verts(scannet_data: str, scene_id: str) -> list[str]:
    """`{scene}_vert.npy` / `_aligned_vert.npy` -> OBJ point dumps with
    per-vertex colors (data/scannet/visualize.py:15-35)."""
    written = []
    for suffix in ("vert", "aligned_vert"):
        npy = os.path.join(scannet_data, f"{scene_id}_{suffix}.npy")
        if not os.path.exists(npy):
            continue
        verts = np.load(npy)
        out = os.path.join(scannet_data, f"{scene_id}_{suffix}s.obj")
        with open(out, "w") as f:
            for v in verts:
                f.write(
                    "v " + " ".join(str(float(x)) for x in v[:6]) + "\n"
                )
        written.append(out)
    return written


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    m = sub.add_parser("mesh")
    m.add_argument("--scans_dir", required=True)
    m.add_argument("--out_dir", required=True)
    m.add_argument("--scene_id", default="",
                   help="one scene; default: every scene dir in scans_dir")

    v = sub.add_parser("verts")
    v.add_argument("--scannet_data", required=True)
    v.add_argument("--scene_id", required=True)

    args = p.parse_args(argv)
    if args.cmd == "mesh":
        scenes = (
            [args.scene_id]
            if args.scene_id
            else sorted(
                d for d in os.listdir(args.scans_dir)
                if os.path.isdir(os.path.join(args.scans_dir, d))
            )
        )
        for scene in scenes:
            out = export_aligned_mesh(args.scans_dir, scene, args.out_dir)
            print(f"wrote {out}")
    else:
        for out in dump_scene_verts(args.scannet_data, args.scene_id):
            print(f"wrote {out}")


if __name__ == "__main__":
    main()
