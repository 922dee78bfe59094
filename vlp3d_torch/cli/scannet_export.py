"""Offline ScanNet export + preprocess-cache CLI: the port's counterpart
of ``vlp3d/cli/scannet_export.py``.

The reference's offline pipeline entry points
(`data/scannet/batch_load_scannet_data.py:batch_export` and
`scripts/preprocess/point_cloud.py:work`) as one command:

  python -m vlp3d_torch.cli.scannet_export \
      --scans_dir data/scannet/scans \
      --labels_tsv data/scannet/meta_data/scannetv2-labels.combined.tsv \
      --output_dir data/scannet_data \
      --splits train,val --preprocess

Per scan: read `_vh_clean_2.ply` + aggregation/segs jsons + the
axis-align meta, write the six `{scene}_*.npy` exports (9-col vertices
incl. face normals), then optionally fuse the
`{scene}_preprocess_{split}.npy` / `_pcl_color_{split}.npy` caches the
joint dataset loads (lib/joint/dataset.py:598-601); split membership
comes from `--meta_dir`'s scannetv2_{split}.txt lists when given,
otherwise every exported scene lands in every requested split.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from vlp3d_torch.data.scannet import (
    build_preprocess,
    export_one_scan,
    read_label_map,
)


def scan_names(scans_dir: str) -> list:
    return sorted(
        d for d in os.listdir(scans_dir)
        if os.path.isdir(os.path.join(scans_dir, d))
    )


def split_scenes(meta_dir: str | None, split: str, fallback: list) -> list:
    if not meta_dir:
        return fallback
    path = os.path.join(meta_dir, f"scannetv2_{split}.txt")
    with open(path) as f:
        wanted = {line.strip() for line in f if line.strip()}
    return [s for s in fallback if s in wanted]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--scans_dir", required=True)
    p.add_argument("--labels_tsv", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--meta_dir", default="")
    p.add_argument("--splits", default="train,val")
    p.add_argument("--preprocess", action="store_true")
    p.add_argument("--use_color", action="store_true")
    p.add_argument("--no_normal", action="store_true")
    p.add_argument("--multiview_hdf5", default="")
    p.add_argument("--num_scans", type=int, default=-1)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    label_map = read_label_map(args.labels_tsv)
    names = scan_names(args.scans_dir)
    if args.num_scans >= 0:
        names = names[: args.num_scans]

    rng = np.random.default_rng(args.seed)
    for name in names:
        export_one_scan(
            args.scans_dir, name, label_map,
            os.path.join(args.output_dir, name), rng=rng,
        )
        print(f"exported {name}")

    if args.preprocess:
        for split in args.splits.split(","):
            for name in split_scenes(args.meta_dir or None, split, names):
                build_preprocess(
                    args.output_dir, name, split,
                    use_color=args.use_color,
                    use_normal=not args.no_normal,
                    multiview_path=args.multiview_hdf5 or None,
                )
                print(f"preprocess[{split}] {name}")


if __name__ == "__main__":
    main()
