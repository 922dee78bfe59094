"""Synthetic scene generator (numpy) for tests and the chip smoke run.

The port's own copy of ``make_batch``, ``make_synthetic_dataset`` and
``tiny_config`` from ``vlp3d/data/synthetic.py``, and of the synthetic
ScanQA maker the JAX trainers share (``_synthetic_qa`` in
``vlp3d/cli/train_scanqa.py``): the same seed gives the same arrays, so
the two packages can be fed identical scenes.
"""

from __future__ import annotations

import numpy as np

from vlp3d_torch.config import Config, DatasetConfig, ModelConfig

GT_VOTE_FACTOR = 3


def make_batch(config: Config, *, batch_size: int = 2, num_points: int = 1024,
               num_objects: int = 6, seed: int = 0, epoch: int = 0,
               istrain: int = 1) -> dict:
    """Random scenes: `num_objects` axis-aligned boxes with points inside,
    plus background clutter; GT votes point at box centers."""
    rng = np.random.default_rng(seed)
    ds = config.dataset
    cfg = config.model
    b = batch_size
    n = num_points
    k2 = ds.max_num_obj
    l = cfg.lang_num_max
    t = cfg.bert_seq_len
    in_dim = cfg.input_feature_dim

    point_clouds = np.zeros((b, n, 3 + in_dim), np.float32)
    center_label = np.zeros((b, k2, 3), np.float32)
    sem_cls_label = np.zeros((b, k2), np.int64)
    size_class_label = np.zeros((b, k2), np.int64)
    size_residual_label = np.zeros((b, k2, 3), np.float32)
    heading_class_label = np.zeros((b, k2), np.int64)
    heading_residual_label = np.zeros((b, k2), np.float32)
    vote_label = np.zeros((b, n, 3 * GT_VOTE_FACTOR), np.float32)
    vote_label_mask = np.zeros((b, n), np.int64)
    instance_labels = np.zeros((b, n), np.int64)
    box_label_mask = np.zeros((b, k2), np.float32)

    mean_size = config.dataset.mean_size_arr()

    centers = rng.uniform(0.5, 5.5, size=(b, num_objects, 3)).astype(
        np.float32)
    sizes = rng.uniform(0.4, 1.2, size=(b, num_objects, 3)).astype(np.float32)

    pts_per_obj = (n // 2) // num_objects
    for bi in range(b):
        cursor = 0
        for oi in range(num_objects):
            c, s = centers[bi, oi], sizes[bi, oi]
            pts = rng.uniform(-0.5, 0.5, size=(pts_per_obj, 3)) * s + c
            sl = slice(cursor, cursor + pts_per_obj)
            point_clouds[bi, sl, :3] = pts
            vote_label[bi, sl] = np.tile(c - pts, (1, GT_VOTE_FACTOR))
            vote_label_mask[bi, sl] = 1
            instance_labels[bi, sl] = oi + 1
            cursor += pts_per_obj
            cls = int(rng.integers(0, ds.num_class))
            center_label[bi, oi] = c
            sem_cls_label[bi, oi] = cls
            size_class_label[bi, oi] = cls
            size_residual_label[bi, oi] = s - mean_size[cls]
            box_label_mask[bi, oi] = 1.0
        # background clutter
        point_clouds[bi, cursor:, :3] = rng.uniform(0, 6, size=(n - cursor, 3))
    point_clouds[..., 3:] = rng.normal(size=(b, n, in_dim)).astype(np.float32)

    # per-sentence refs: each sentence refers to a random object
    lang_num = rng.integers(1, l + 1, size=(b,))
    ref_obj = rng.integers(0, num_objects, size=(b, l))
    batch_idx = np.arange(b)[:, None]
    ref_center = center_label[batch_idx, ref_obj]
    ref_size_class = size_class_label[batch_idx, ref_obj]
    ref_size_residual = size_residual_label[batch_idx, ref_obj]
    object_cat = sem_cls_label[batch_idx, ref_obj]

    input_ids = rng.integers(1000, 5000, size=(b, l, t)).astype(np.int32)
    input_ids[..., 0] = 101  # CLS
    seq_lens = rng.integers(6, t - 1, size=(b, l))
    for bi in range(b):
        for li in range(l):
            input_ids[bi, li, seq_lens[bi, li]] = 102  # SEP
            input_ids[bi, li, seq_lens[bi, li] + 1:] = 0
    attention_mask = (input_ids != 0).astype(np.int32)

    return {
        "point_clouds": point_clouds,
        "center_label": center_label,
        "sem_cls_label": sem_cls_label,
        "size_class_label": size_class_label,
        "size_residual_label": size_residual_label,
        "heading_class_label": heading_class_label,
        "heading_residual_label": heading_residual_label,
        "vote_label": vote_label,
        "vote_label_mask": vote_label_mask,
        "instance_labels": instance_labels,
        "box_label_mask": box_label_mask,
        "num_bbox": np.full((b,), num_objects, np.int64),
        "ref_center_label_list": ref_center,
        "ref_heading_class_label_list": np.zeros((b, l), np.int64),
        "ref_heading_residual_label_list": np.zeros((b, l), np.float32),
        "ref_size_class_label_list": ref_size_class,
        "ref_size_residual_label_list": ref_size_residual,
        "object_cat_list": object_cat,
        "lang_num": lang_num.astype(np.int32),
        "input_ids": input_ids,
        "bert_attention_mask": attention_mask,
        "answer_cat": rng.integers(
            0, cfg.num_answers, size=(b * l,)).astype(np.int32),
        "epoch": np.int32(epoch),
        "istrain": np.int32(istrain),
        "random": np.float32(0.7),
    }


def make_synthetic_dataset(config: Config, *, n_scenes: int = 2,
                           n_points: int = 2000, n_obj: int = 4,
                           anns_per_scene: int = 5, split: str = "train",
                           seed: int = 0, **dataset_kwargs):
    """ScanReferJointDataset over random in-memory scenes (no ScanNet
    needed): the stand-in for the real data pipeline in tests and on the
    card."""
    from vlp3d_torch.data.dataset import (
        InMemorySceneSource,
        ScanReferJointDataset,
    )
    from vlp3d_torch.data.tokenizer import HashTokenizer

    rng = np.random.default_rng(seed)
    scenes = {}
    anns = []
    names = ["chair", "table", "bed", "sofa"]
    for si in range(n_scenes):
        sid = f"scene{si:04d}_00"
        bboxes = np.zeros((n_obj, 8), np.float32)
        pts = rng.uniform(0, 5, (n_points, 3)).astype(np.float32)
        instance = np.zeros(n_points, np.int64)
        semantic = np.zeros(n_points, np.int64)
        per = n_points // (2 * n_obj)
        for i in range(n_obj):
            c = rng.uniform(1, 4, 3)
            s = rng.uniform(0.5, 1.0, 3)
            sl = slice(i * per, (i + 1) * per)
            pts[sl] = c + rng.uniform(-0.5, 0.5, (per, 3)) * s
            instance[sl] = i + 1
            semantic[sl] = 5
            bboxes[i, 0:3] = c
            bboxes[i, 3:6] = s
            bboxes[i, 6] = 5
            bboxes[i, 7] = i + 10
        # extra per-point feature channels so point_clouds ends up at
        # (N, 3 + input_feature_dim) after the height channel is added
        extra = max(config.model.input_feature_dim - 1, 0)
        feats = rng.normal(size=(n_points, extra)).astype(np.float32)
        scenes[sid] = {
            "point_cloud": np.concatenate([pts, feats], axis=1),
            "instance_labels": instance,
            "semantic_labels": semantic,
            "instance_bboxes": bboxes,
        }
        for a in range(anns_per_scene):
            obj = a % n_obj
            anns.append({
                "scene_id": sid,
                "object_id": str(10 + obj),
                "object_name": names[obj % len(names)],
                "ann_id": str(a),
                "token": ["the", names[obj % len(names)], "near", "the",
                          "wall"],
            })

    return ScanReferJointDataset(
        anns, InMemorySceneSource(scenes), HashTokenizer(), split=split,
        num_points=config.dataset.num_points,
        lang_num_max=config.model.lang_num_max,
        bert_max_len=config.model.bert_seq_len,
        mean_size_arr=config.dataset.mean_size_arr(), **dataset_kwargs)


def synthetic_qa(config: Config, n_scenes: int = 2,
                 questions_per_scene: int = 4):
    """Synthetic scenes and ScanQA-style questions about them (no assets):
    (qa annotations, scene source). The JAX maker also returns a GloVe
    dictionary for its LSTM model; JointNet reads BERT ids and needs
    none."""
    from vlp3d_torch.data.dataset import InMemorySceneSource

    base = make_synthetic_dataset(config, n_scenes=n_scenes,
                                  n_points=config.dataset.num_points)
    scenes = base.scene_source.scenes
    names = ["chair", "table", "bed", "sofa"]
    qa = []
    for sid in scenes:
        for q in range(questions_per_scene):
            name = names[q % 4]
            qa.append({
                "scene_id": sid,
                "question_id": f"{sid}-{q}",
                "question": f"what color is the {name} near the wall",
                "object_ids": [10 + q % 4],
                "object_names": [name],
                "answers": [["red", "blue", "two", "wood"][q % 4]],
            })
    return qa, InMemorySceneSource(scenes)


def tiny_config(**overrides) -> Config:
    """Small-shape Config for CPU tests (vlp3d.data.synthetic.tiny_config)."""
    model = ModelConfig(
        input_feature_dim=4,
        num_proposal=16,
        sa_npoints=(64, 32, 16, 8),
        sa_radii=(0.4, 0.8, 1.2, 1.6),
        sa_nsamples=(8, 8, 4, 4),
        lang_num_max=4,
        bert_seq_len=12,
        max_des_len=8,
        fusion_layer=2,
        num_answers=32,
        multiview_offset=3,
        multiview_dim=4,
        **overrides,
    )
    return Config(
        dataset=DatasetConfig(max_num_obj=32, num_points=512), model=model)
