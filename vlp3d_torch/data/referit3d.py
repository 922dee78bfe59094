"""ReferIt3D (Nr3D / Sr3D / Sr3D+) annotation conversion.

The port's own copy of ``vlp3d/data/referit3d.py``, after the
reference's preprocess family
(`scripts/preprocess/{nr3d,sr3d,sr3d_plus}.py`,
`scripts/grounding_scripts/organize_referit3d.py`): parse the ReferIt3D
CSV release into ScanRefer-schema entries
{scene_id, object_id, object_name, ann_id, description, token} and split
them by the ScanNet v2 train/val scene lists, so the grounding pipeline
can train on Nr3D/Sr3D unchanged.

Differences from the reference scripts, kept deliberately:
  * stdlib csv instead of pandas (no extra dependency);
  * ann_id convention preserved per dataset: nr3d keeps the CSV
    ``assignmentid`` (nr3d.py:42), sr3d/sr3d+ number annotations from 0
    in row order (sr3d.py:39-47).
"""

from __future__ import annotations

import ast
import csv
import json
import os


def _read_scene_list(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def parse_referit3d_csv(
    csv_path: str, *, ann_id_mode: str = "assignment"
) -> list[dict]:
    """ReferIt3D CSV rows -> ScanRefer-schema entries.

    ann_id_mode: 'assignment' (nr3d — use the CSV assignmentid) or
    'sequential' (sr3d/sr3d+ — number from 0 in row order).
    """
    entries = []
    seq = 0
    with open(csv_path, newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            tokens = row.get("tokens", "")
            try:
                token = ast.literal_eval(tokens) if tokens else []
            except (ValueError, SyntaxError):
                token = tokens.split()
            if ann_id_mode == "assignment":
                ann_id = str(row.get("assignmentid", seq))
            else:
                ann_id = seq
            entries.append(
                {
                    "scene_id": row["scan_id"],
                    "object_id": str(row["target_id"]),
                    "object_name": row["instance_type"],
                    "ann_id": ann_id,
                    "description": row["utterance"].lower(),
                    "token": token,
                }
            )
            seq += 1
    return entries


def split_by_scene(
    entries: list[dict],
    train_scenes: list[str],
    val_scenes: list[str],
) -> tuple[list[dict], list[dict]]:
    """Split entries into (train, val) by scene id; entries in neither
    list are dropped with a warning, as in nr3d.py:48-51."""
    train_set, val_set = set(train_scenes), set(val_scenes)
    train, val = [], []
    for e in entries:
        if e["scene_id"] in val_set:
            val.append(e)
        elif e["scene_id"] in train_set:
            train.append(e)
        else:
            print(f"scene {e['scene_id']} not in train/val split")
    return train, val


def convert_referit3d(
    csv_path: str,
    out_dir: str,
    *,
    name: str | None = None,
    train_list: str | None = None,
    val_list: str | None = None,
    scanrefer_dir: str | None = None,
) -> tuple[str, str]:
    """CSV -> {name}_train.json / {name}_val.json in ScanRefer schema.

    Scene split comes from explicit scannetv2_{train,val}.txt lists, or —
    like organize_referit3d.py:16-21 — from the scene ids present in an
    existing ScanRefer train/val pair.
    """
    if name is None:
        name = os.path.splitext(os.path.basename(csv_path))[0]
    ann_id_mode = "assignment" if name.startswith("nr3d") else "sequential"
    entries = parse_referit3d_csv(csv_path, ann_id_mode=ann_id_mode)
    if train_list and val_list:
        train_scenes = _read_scene_list(train_list)
        val_scenes = _read_scene_list(val_list)
    elif scanrefer_dir:
        def scenes(split):
            p = os.path.join(
                scanrefer_dir, f"ScanRefer_filtered_{split}.json"
            )
            with open(p) as f:
                return sorted({d["scene_id"] for d in json.load(f)})

        train_scenes, val_scenes = scenes("train"), scenes("val")
    else:
        raise ValueError(
            "provide train_list+val_list or scanrefer_dir for the split"
        )
    train, val = split_by_scene(entries, train_scenes, val_scenes)
    val = sorted(val, key=lambda e: e["scene_id"])
    os.makedirs(out_dir, exist_ok=True)
    train_path = os.path.join(out_dir, f"{name}_train.json")
    val_path = os.path.join(out_dir, f"{name}_val.json")
    with open(train_path, "w") as f:
        json.dump(train, f, indent=4)
    with open(val_path, "w") as f:
        json.dump(val, f, indent=4)
    return train_path, val_path
