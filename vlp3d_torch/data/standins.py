"""Stand-in assets in the layouts of the real downloads.

The port's own copy of ``vlp3d/data/standins.py``'s writers: one
preprocessed ScanNet scene (the ``_preprocess_val`` / ``_ins_label`` /
``_sem_label`` / ``_aligned_bbox`` npys, columns xyz, normals, 128-d
multiview), its multiview-as-hdf5 flavour (a 6-column npy and
``enet_feats_maxpool.hdf5``, written by :mod:`vlp3d_torch.data.hdf5`),
``ScanRefer_filtered_val.json``, ``ScanQA_v1.0_val.json`` and a BERT
``vocab.txt`` with HF-layout ``pytorch_model.bin`` (tiny, seeded). The
same seed writes the same arrays, tensors and vocabulary as the JAX
writers, so both packages read one stand-in directory alike.
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


def write_bert_assets(bert_dir, hidden: int = 32, layers: int = 2) -> None:
    """vocab.txt and an HF-layout pytorch_model.bin (tiny dims, seeded):
    the tensors of ``vlp3d/data/standins.py``'s writer, key for key."""
    import torch

    write_bert_vocab(bert_dir)
    v, h, i, pos = len(VOCAB), hidden, 2 * hidden, 64
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.05

    sd = {
        "embeddings.word_embeddings.weight": t(v, h),
        "embeddings.position_embeddings.weight": t(pos, h),
        "embeddings.token_type_embeddings.weight": t(2, h),
        "embeddings.LayerNorm.weight": torch.ones(h),
        "embeddings.LayerNorm.bias": torch.zeros(h),
        "pooler.dense.weight": t(h, h),  # deliberately unconsumed
        "pooler.dense.bias": torch.zeros(h),
    }
    for layer in range(layers):
        p = f"encoder.layer.{layer}."
        for name, shape in (
            ("attention.self.query", (h, h)),
            ("attention.self.key", (h, h)),
            ("attention.self.value", (h, h)),
            ("attention.output.dense", (h, h)),
            ("intermediate.dense", (i, h)),
            ("output.dense", (h, i)),
        ):
            sd[p + name + ".weight"] = t(*shape)
            sd[p + name + ".bias"] = torch.zeros(shape[0])
        for ln in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + ln + ".weight"] = torch.ones(h)
            sd[p + ln + ".bias"] = torch.zeros(h)
    torch.save(sd, os.path.join(bert_dir, "pytorch_model.bin"))


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


def write_scene_assets_nomv(nomv_dir, arrays) -> str:
    """The multiview-as-hdf5 flavour of the same scene: a 6-column (xyz,
    normals) preprocess npy plus ``enet_feats_maxpool.hdf5`` holding the
    per-point 128-d block under the scene id, the layout the reference's
    task-variant datasets read. Appending the hdf5 features to the npy
    gives the baked [xyz, normal, multiview] cache bit for bit. Returns
    the hdf5 path."""
    from vlp3d_torch.data.hdf5 import DatasetWriter

    pc = np.concatenate([arrays["xyz"], arrays["normals"]], axis=1)
    np.save(os.path.join(nomv_dir, f"{SCENE}_preprocess_val.npy"), pc)
    np.save(os.path.join(nomv_dir, f"{SCENE}_ins_label.npy"), arrays["ins"])
    np.save(os.path.join(nomv_dir, f"{SCENE}_sem_label.npy"), arrays["sem"])
    np.save(os.path.join(nomv_dir, f"{SCENE}_aligned_bbox.npy"),
            arrays["bboxes"])
    hdf5_path = os.path.join(nomv_dir, "enet_feats_maxpool.hdf5")
    with DatasetWriter(hdf5_path) as w:
        w.add(SCENE, arrays["mv"])
    return hdf5_path


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


def write_scanqa(scanqa_dir) -> None:
    """ScanQA_v1.0_val.json: three questions about the scene."""
    qa = [
        {
            "scene_id": SCENE, "question_id": f"val-{SCENE}-{k}",
            "question": q, "answers": a,
            "object_ids": [0], "object_names": ["chair"],
        }
        for k, (q, a) in enumerate([
            ("what color is the chair", ["brown"]),
            ("where is the table", ["next to the chair", "center"]),
            ("how many chairs are there", ["2"]),
        ])
    ]
    with open(os.path.join(scanqa_dir, "ScanQA_v1.0_val.json"), "w") as f:
        json.dump(qa, f)


def write_standin_assets(root: str, seed: int = 7) -> dict:
    """The BERT assets, the scene (baked, and as npy + hdf5) and the
    annotations under ``root``; returns the directory of each by the CLI
    flag that takes it (``bert_dir`` holds vocab.txt, for
    ``--bert_vocab``; ``multiview_nomv_data`` the scene for
    ``--scannet_data`` with ``--multiview_hdf5``)."""
    rng = np.random.default_rng(seed)
    paths = {
        "bert_dir": os.path.join(root, "bert"),
        "scannet_data": os.path.join(root, "scannet_data"),
        "scanrefer_dir": os.path.join(root, "scanrefer"),
        "scanqa_dir": os.path.join(root, "scanqa"),
        "multiview_nomv_data": os.path.join(root, "scannet_data_nomv"),
    }
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    write_bert_assets(paths["bert_dir"])
    arrays = write_scene_assets(paths["scannet_data"], rng)
    write_scene_assets_nomv(paths["multiview_nomv_data"], arrays)
    write_scanrefer(paths["scanrefer_dir"])
    write_scanqa(paths["scanqa_dir"])
    return paths
