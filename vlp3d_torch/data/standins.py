"""Stand-in assets in the layouts of the real downloads.

The port's own copy of the grounding half of ``vlp3d/data/standins.py``:
one preprocessed ScanNet scene (the ``_preprocess_val`` / ``_ins_label``
/ ``_sem_label`` / ``_aligned_bbox`` npys, columns xyz, normals,
128-d multiview), ``ScanRefer_filtered_val.json``, and a BERT
``vocab.txt``. The same seed writes the same files as the JAX writers,
so both packages read one stand-in directory alike. The multiview hdf5
flavour waits for a machine with ``h5py``; ScanQA is ROADMAP.md queue A
item A17; the BERT weights file is not needed by the grounding path,
whose text encoder weights come from the model's state dict.
"""

from __future__ import annotations

import json
import os

import numpy as np

SCENE = "scene0000_00"

VOCAB = (
    "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "a", "chair",
    "table", "brown", "wooden", "next", "to", "round", "gray", "couch",
    "against", "wall", "white", "refrigerator", "standing", "from",
    "left", "it", "is", "with", "an", "on", "this", "2nd", ",", ".",
    ";", "'", "s", "##s", "##word", "unusual", "in", "of",
)


def write_bert_vocab(bert_dir) -> str:
    """vocab.txt of the stand-in BERT; returns its path."""
    path = os.path.join(bert_dir, "vocab.txt")
    with open(path, "w") as f:
        f.write("\n".join(VOCAB) + "\n")
    return path


def write_scene_assets(scannet_data, rng, stale: bool = False) -> dict:
    """One preprocessed scene in the upstream cache's column layout (xyz,
    normals, 128-d multiview; ``stale`` swaps the last two blocks, the
    order the loader's layout check rejects). Returns the arrays."""
    n = 2000
    xyz = rng.uniform(0, 4, (n, 3)).astype(np.float32)
    normals = rng.normal(size=(n, 3)).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    mv = rng.normal(0, 2, (n, 128)).astype(np.float32)
    ins = np.zeros(n, np.int64)
    sem = np.full(n, 3, np.int64)
    bboxes = np.zeros((2, 8), np.float64)
    for k in range(2):
        c = np.array([1.5 + k, 1.5, 1.0], np.float32)
        s = np.array([1.0, 1.0, 1.0], np.float32)
        sl = slice(k * 400, (k + 1) * 400)
        xyz[sl] = c + rng.uniform(-0.5, 0.5, (400, 3)) * s
        ins[sl] = k + 1
        bboxes[k] = [*c, *s, 3 if k == 0 else 4, k]
    # concatenate after the cluster writes so the saved cloud holds the
    # instances its labels and boxes describe
    blocks = [xyz, mv, normals] if stale else [xyz, normals, mv]
    pc = np.concatenate(blocks, axis=1)
    np.save(os.path.join(scannet_data, f"{SCENE}_preprocess_val.npy"), pc)
    np.save(os.path.join(scannet_data, f"{SCENE}_ins_label.npy"), ins)
    np.save(os.path.join(scannet_data, f"{SCENE}_sem_label.npy"), sem)
    np.save(os.path.join(scannet_data, f"{SCENE}_aligned_bbox.npy"), bboxes)
    return {"xyz": xyz, "normals": normals, "mv": mv, "ins": ins,
            "sem": sem, "bboxes": bboxes}


def write_scanrefer(scanrefer_dir) -> None:
    """ScanRefer_filtered_val.json: three annotations of the scene."""
    anns = [
        {
            "scene_id": SCENE, "object_id": str(oid),
            "object_name": name, "ann_id": str(k),
            "description": text, "token": text.split(),
        }
        for k, (oid, name, text) in enumerate([
            (0, "chair", "the brown wooden chair next to the table"),
            (0, "chair", "a chair standing against the wall"),
            (1, "table", "the round table in the wall"),
        ])
    ]
    with open(os.path.join(scanrefer_dir, "ScanRefer_filtered_val.json"),
              "w") as f:
        json.dump(anns, f)


def write_standin_assets(root: str, seed: int = 7) -> dict:
    """The vocabulary, the scene and the annotations under ``root``;
    returns the directory of each by the CLI flag that takes it
    (``bert_dir`` holds vocab.txt, for ``--bert_vocab``)."""
    rng = np.random.default_rng(seed)
    paths = {
        "bert_dir": os.path.join(root, "bert"),
        "scannet_data": os.path.join(root, "scannet_data"),
        "scanrefer_dir": os.path.join(root, "scanrefer"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    write_bert_vocab(paths["bert_dir"])
    write_scene_assets(paths["scannet_data"], rng)
    write_scanrefer(paths["scanrefer_dir"])
    return paths
