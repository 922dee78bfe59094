"""Annotation preprocessing CLI: the port's counterpart of
``vlp3d/cli/preprocess_annotations.py``.

Covers the reference's preprocess script family:

  * ``referit3d`` — ReferIt3D nr3d/sr3d/sr3d+ CSV -> ScanRefer-schema
    train/val jsons (scripts/preprocess/{nr3d,sr3d,sr3d_plus}.py,
    scripts/grounding_scripts/organize_referit3d.py);
  * ``organize`` — flat ScanRefer json -> nested
    {scene_id: {object_id: {ann_id: entry}}} organized json, the asset
    caption evaluation loads (scripts/preprocess/scanrefer.py,
    lib/joint/eval_helper.py:321-322);
  * ``scan2cad`` — Scan2CAD full_annotations.json + aligned_cad2inst_id
    .json -> {scene_id: {instance_id: 3x3 rotation}}
    (scripts/captioning_scripts/Scan2CAD_to_ScanNet.py).

Usage:
  python -m vlp3d_torch.cli.preprocess_annotations referit3d \
      --csv nr3d.csv --out_dir data/referit3d \
      --train_list scannetv2_train.txt --val_list scannetv2_val.txt
  python -m vlp3d_torch.cli.preprocess_annotations organize \
      --scanrefer ScanRefer_filtered.json --out organized.json
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("referit3d")
    r.add_argument("--csv", required=True)
    r.add_argument("--out_dir", required=True)
    r.add_argument("--name", default=None,
                   help="output prefix (default: csv basename)")
    r.add_argument("--train_list", default=None,
                   help="scannetv2_train.txt scene list")
    r.add_argument("--val_list", default=None)
    r.add_argument("--scanrefer_dir", default=None,
                   help="derive the split from an existing ScanRefer pair")

    o = sub.add_parser("organize")
    o.add_argument("--scanrefer", required=True)
    o.add_argument("--out", required=True)

    s = sub.add_parser("scan2cad")
    s.add_argument("--annotations", required=True,
                   help="Scan2CAD full_annotations.json")
    s.add_argument("--cad2inst", required=True,
                   help="aligned_cad2inst_id.json")
    s.add_argument("--out", required=True)

    args = p.parse_args(argv)

    if args.cmd == "referit3d":
        from vlp3d_torch.data.referit3d import convert_referit3d

        train_path, val_path = convert_referit3d(
            args.csv,
            args.out_dir,
            name=args.name,
            train_list=args.train_list,
            val_list=args.val_list,
            scanrefer_dir=args.scanrefer_dir,
        )
        print(f"Saving {train_path}")
        print(f"Saving {val_path}")
    elif args.cmd == "organize":
        from vlp3d_torch.eval.captioning import organize_scanrefer

        with open(args.scanrefer) as f:
            data = json.load(f)
        with open(args.out, "w") as f:
            json.dump(organize_scanrefer(data), f, indent=4)
        print(f"Saving {args.out}")
    else:
        from vlp3d_torch.data.scan2cad import parse_scan2cad_rotations

        with open(args.annotations) as f:
            annotations = json.load(f)
        with open(args.cad2inst) as f:
            cad2inst = json.load(f)
        parsed = parse_scan2cad_rotations(annotations, cad2inst)
        with open(args.out, "w") as f:
            json.dump(parsed, f, indent=4)
        print(f"number of scenes: {len(parsed)}")
        print(f"Saving {args.out}")


if __name__ == "__main__":
    main()
