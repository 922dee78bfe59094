"""ScanRefer joint dataset: scene chunking, GT construction, augmentation.

The port's own copy of ``vlp3d/data/dataset.py``: for the same
annotations, scenes, tokenizer and seed it builds the same batches, key
for key and bit for bit, on the fused native path and on the numpy path.
With ``glove=`` (and ``caption_vocab=``) items also carry the GloVe and
caption-vocabulary fields of the legacy task pipelines (ScanQA with
MCAN, RefNet, CapNet), built by :mod:`vlp3d_torch.data.glove`.
Batches stay numpy on the host: the consumer copies them to the card,
and only the consuming thread touches CUDA.

Host-side numpy port of `lib/joint/dataset.py` (ScannetReferenceDataset):

  * annotations are grouped into chunks of <= lang_num_max sentences per
    scene (`split_scene_new`, dataset.py:488-526), reshuffled each epoch
    via `shuffle_data` (:528-535);
  * __getitem__ (:537-919): loads the preprocessed scene cloud, samples
    num_points, adds the height feature (0.99th-percentile floor,
    :603-607), applies flip/rot/scale/translate augmentation, regenerates
    GT votes from instance labels AFTER augmentation (:669-678), builds
    MAX_NUM_OBJ-padded GT boxes + per-sentence ref labels, optionally
    appends prompt-generated synthetic sentences (`lang_num_aug`,
    :689-725), and BERT-tokenizes lang_num_max sentences to length 50;
  * all randomness is a seeded np.random.Generator (dataset.py:472-473).

Scene tensors come from a `SceneSource`; `DirectorySceneSource` reads the
offline preprocessing outputs (vlp3d/data/scannet.py writes them) and
`InMemorySceneSource` serves synthetic fixtures for tests.
"""

from __future__ import annotations

import os
import random as pyrandom

import numpy as np

from vlp3d_torch import native
from vlp3d_torch.data.augment import augment_scene, draw_augment
from vlp3d_torch.data.glove import (
    caption_batch_fields,
    glove_batch_fields,
    transform_description_caption,
    transform_descriptions,
)
from vlp3d_torch.data.hdf5 import read_datasets
from vlp3d_torch.data.prompt import Prompt
from vlp3d_torch.geometry.boxes import get_3d_box_batch

MAX_NUM_OBJ = 256
GT_VOTE_FACTOR = 3

# nyu40 ids participating in detection (model_util_scannet.py:90)
NYU40_IDS = frozenset(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
     23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]
)

SCANNET_TYPE2CLASS = {
    "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4, "door": 5,
    "window": 6, "bookshelf": 7, "picture": 8, "counter": 9, "desk": 10,
    "curtain": 11, "refrigerator": 12, "shower curtain": 13, "toilet": 14,
    "sink": 15, "bathtub": 16, "others": 17,
}


def load_raw2label(tsv_path: str) -> dict:
    """raw ScanNet name -> 18-class id from scannetv2-labels.combined.tsv
    (dataset.py:60-77)."""
    raw2label = {}
    with open(tsv_path, encoding="utf-8") as f:
        lines = f.read().splitlines()[1:]
    for line in lines:
        elements = line.split("\t")
        raw_name, nyu40_name = elements[1], elements[7]
        raw2label[raw_name] = SCANNET_TYPE2CLASS.get(
            nyu40_name, SCANNET_TYPE2CLASS["others"]
        )
    return raw2label


def build_nyu40id2class(tsv_path: str) -> dict:
    out = {0: 0}
    with open(tsv_path, encoding="utf-8") as f:
        lines = f.read().splitlines()[1:]
    for line in lines:
        elements = line.split("\t")
        nyu40_id = int(elements[4])
        nyu40_name = elements[7]
        if nyu40_id in NYU40_IDS:
            out[nyu40_id] = SCANNET_TYPE2CLASS.get(
                nyu40_name, SCANNET_TYPE2CLASS["others"]
            )
    return out


def unique_multiple_lookup(scanrefer, raw2label) -> dict:
    """scene -> object -> ann -> 0 (unique) / 1 (multiple)
    (dataset.py:79-134)."""
    sem_by_scene: dict = {}
    seen: dict = {}
    for data in scanrefer:
        sid, oid = data["scene_id"], data["object_id"]
        name = " ".join(data["object_name"].split("_"))
        sem_by_scene.setdefault(sid, [])
        if oid not in seen.setdefault(sid, set()):
            seen[sid].add(oid)
            sem_by_scene[sid].append(raw2label.get(name, 17))
    sem_by_scene = {k: np.array(v) for k, v in sem_by_scene.items()}

    lookup: dict = {}
    for data in scanrefer:
        sid, oid, ann = data["scene_id"], data["object_id"], data["ann_id"]
        name = " ".join(data["object_name"].split("_"))
        sem = raw2label.get(name, 17)
        um = 0 if (sem_by_scene[sid] == sem).sum() == 1 else 1
        # ann_id arrives as a str in ScanRefer json; normalize to int —
        # get_item queries with the int ann_id_list values (a str key
        # here made every lookup miss to the 0 default, flattening the
        # unique/multiple eval breakdown; caught by
        # tests/test_refparity_dataset.py)
        lookup.setdefault(sid, {}).setdefault(str(oid), {})[int(ann)] = um
    return lookup


class InMemorySceneSource:
    """dict scene_id -> {point_cloud, instance_labels, semantic_labels,
    instance_bboxes}. point_cloud is the preprocessed (N, 3+F) array."""

    def __init__(self, scenes: dict):
        self.scenes = scenes

    def __call__(self, scene_id: str, split: str) -> dict:
        return self.scenes[scene_id]


class DirectorySceneSource:
    """Reads the offline preprocessing outputs:
    {scene}_preprocess_{split}.npy (points+features, dataset.py:598-601)
    plus {scene}_ins_label.npy / _sem_label.npy / _aligned_bbox.npy
    (batch_load_scannet_data.py outputs).

    multiview_hdf5: optional enet_feats_maxpool.hdf5 path (the task-variant
    datasets' per-point 128-d ENet features, lib/vqa/dataset.py:967-990 /
    lib/visual_grounding/dataset.py) — appended as extra point-cloud
    columns when the preprocess npy doesn't already bake them in."""

    def __init__(self, root: str, multiview_hdf5: str | None = None):
        import threading

        self.root = root
        self.cache: dict = {}
        self.multiview_hdf5 = multiview_hdf5
        self._mv = None  # {scene_id: memory map}, read at first use
        # loader worker threads call __call__ concurrently; serialize the
        # lazy read of the hdf5's index and first-touch cache fill
        self._lock = threading.Lock()

    def _multiview(self, scene_id: str):
        """The scene's (N, 128) float32 multiview block, copied out of the
        hdf5 (read by vlp3d_torch.data.hdf5; no h5py needed)."""
        if self._mv is None:
            self._mv = read_datasets(self.multiview_hdf5)
        if scene_id not in self._mv:
            raise KeyError(f"{scene_id} is not in {self.multiview_hdf5}")
        return np.array(self._mv[scene_id], np.float32)

    def __call__(self, scene_id: str, split: str) -> dict:
        key = (scene_id, split)
        got = self.cache.get(key)
        if got is not None:
            return got
        with self._lock:
            if key not in self.cache:
                p = os.path.join(self.root, scene_id)
                point_cloud = np.load(f"{p}_preprocess_{split}.npy")
                from vlp3d_torch.data.scannet import check_preprocess_layout

                check_preprocess_layout(
                    point_cloud, f"{p}_preprocess_{split}.npy"
                )
                if self.multiview_hdf5 is not None:
                    point_cloud = np.concatenate(
                        [point_cloud, self._multiview(scene_id)], axis=1
                    )
                self.cache[key] = {
                    "point_cloud": point_cloud,
                    "instance_labels": np.load(f"{p}_ins_label.npy"),
                    "semantic_labels": np.load(f"{p}_sem_label.npy"),
                    "instance_bboxes": np.load(f"{p}_aligned_bbox.npy"),
                }
            return self.cache[key]


class ScanReferJointDataset:
    def __init__(
        self,
        scanrefer: list,
        scene_source,
        tokenizer,
        *,
        split: str = "train",
        num_points: int = 40000,
        lang_num_max: int = 8,
        lang_num_aug: int = 0,
        use_height: bool = True,
        augment: bool = False,
        shuffle: bool = False,
        mean_size_arr: np.ndarray | None = None,
        raw2label: dict | None = None,
        nyu40id2class: dict | None = None,
        bert_max_len: int = 50,
        seed: int = 42,
        minor_aug: bool = False,
        glove: dict | None = None,
        max_des_len: int = 30,
        caption_vocab: dict | None = None,
        object_rotations: dict | None = None,
    ):
        """glove (optional): token -> 300-d vector dict. When given, every
        item also carries the GloVe-era LSTM language fields
        (lang_feat/lang_len/main_lang_feat/main_lang_len/first_obj) the
        legacy task pipelines consume (lib/visual_grounding/dataset.py's
        lang path), alongside the BERT input_ids. Incompatible with
        lang_num_aug (prompt-augmented sentences have no GloVe entry).

        caption_vocab (optional, requires glove): {"word2idx", ...} from
        build_caption_vocabulary; items then also carry the
        captioning-era sos/eos-wrapped fields cap_lang_feat / lang_ids /
        cap_len (lib/visual_captioning/dataset.py:157-176).

        object_rotations (optional): the Scan2CAD-derived
        {scene_id: {instance_id: 3x3}} json (vlp3d/data/scan2cad.py) — items
        then carry scene_object_rotations / scene_object_rotation_masks
        (dataset.py:797-809; emitted-only in the reference as well)."""
        self.scanrefer = scanrefer
        self.scene_source = scene_source
        self.tokenizer = tokenizer
        self.split = split
        self.num_points = num_points
        self.lang_num_max = lang_num_max
        self.augment = augment
        self.lang_num_aug = lang_num_aug if augment else 0
        self.use_height = use_height
        self.should_shuffle = shuffle
        self.bert_max_len = bert_max_len
        self.seed = seed
        self._shuffle_round = 0
        self.prompt = Prompt()
        # rare-class duplication (dataset.py:446, 483-485, 561-565):
        # a sentence about a minor-class object is repeated in the next slot
        self.minor_aug = minor_aug
        self.minor_label = ("counter", "curtain", "shower curtain", "bathtub")
        self.object_rotations = object_rotations
        self.mean_size_arr = (
            mean_size_arr
            if mean_size_arr is not None
            else np.ones((18, 3), np.float32)
        )
        self.max_des_len = max_des_len
        self._glove_lang = None
        self._cap_lang = None
        if glove is not None:
            assert self.lang_num_aug == 0, (
                "glove fields are incompatible with lang_num_aug"
            )
            self._glove_lang = transform_descriptions(
                scanrefer, glove, raw2label or {}, max_des_len
            )
            if caption_vocab is not None:
                cap: dict = {}
                for data in scanrefer:
                    cap.setdefault(data["scene_id"], {}).setdefault(
                        str(data["object_id"]), {}
                    )[str(data["ann_id"])] = transform_description_caption(
                        data["token"], glove, caption_vocab, max_des_len
                    )
                self._cap_lang = cap
        self.raw2label = raw2label or {}
        self.nyu40id2class = nyu40id2class or {}
        self.scanrefer_dict: dict = {}
        self.unique_multiple = unique_multiple_lookup(
            scanrefer, self.raw2label
        )
        self.chunks = self.split_scene_new(scanrefer)
        self.num_chunks = len(self.chunks)
        # per-scene statics for the fused loader path: floor percentile and
        # the nyu40 semantic gate are functions of the RAW scene only, so
        # they are computed once per scene instead of once per item.
        # (dict writes are atomic; a duplicate compute under a race is
        # benign because the values are deterministic)
        self._scene_statics_cache: dict = {}
        self._c_out: int | None = None

    # -------------------------------------------------- chunking
    def split_scene_new(self, scanrefer_data):
        """Group annotations into per-scene chunks of
        <= lang_num_max - lang_num_aug (dataset.py:488-526)."""
        cap = self.lang_num_max - self.lang_num_aug
        self.scanrefer_dict = {}
        out, cur_chunk, cur_scene = [], [], []
        scene_id = ""

        def flush_scene(scene):
            nonlocal cur_chunk
            if self.should_shuffle:
                pyrandom.shuffle(scene)
            for item in scene:
                if len(cur_chunk) >= cap:
                    out.append(cur_chunk)
                    cur_chunk = []
                cur_chunk.append(item)
            if cur_chunk:
                out.append(cur_chunk)
                cur_chunk = []

        for data in scanrefer_data:
            self.scanrefer_dict.setdefault(data["scene_id"], []).append(data)
            if scene_id != data["scene_id"]:
                scene_id = data["scene_id"]
                if cur_scene:
                    flush_scene(cur_scene)
                    cur_scene = []
            cur_scene.append(data)
        if cur_scene:
            flush_scene(cur_scene)
        return out

    def _rotation_fields(self, scene_id, gt_box_object_ids, num_bbox):
        """Scan2CAD orientation fields (dataset.py:797-809); empty unless
        object_rotations was provided."""
        if self.object_rotations is None:
            return {}
        n = len(gt_box_object_ids)
        rotations = np.zeros((n, 3, 3), np.float32)
        masks = np.zeros((n,), np.int64)
        scene_rot = self.object_rotations.get(scene_id, {})
        for i in range(num_bbox):
            rot = scene_rot.get(str(int(gt_box_object_ids[i])))
            if rot is not None:
                rotations[i] = np.asarray(rot, np.float32)
                masks[i] = 1
        return {
            "scene_object_rotations": rotations,
            "scene_object_rotation_masks": masks,
        }

    def shuffle_data(self):
        """Re-chunk each epoch (solver calls this; dataset.py:528-535)."""
        self.chunks = self.split_scene_new(self.scanrefer)
        if self.should_shuffle:
            pyrandom.shuffle(self.chunks)
        self._shuffle_round += 1
        assert len(self.chunks) == self.num_chunks

    def __len__(self):
        return self.num_chunks

    # -------------------------------------------------- item
    def _scene_statics(self, scene_id: str, scene: dict):
        """(floor_height, raw sem_ok u8) — raw-scene-only statics, cached.
        floor = np.percentile(z, 0.99) exactly as the per-item path
        (dataset.py:603-607); sem_ok = semantic label in the nyu40
        detection set (the vote gate)."""
        got = self._scene_statics_cache.get(scene_id)
        if got is None:
            pc = scene["point_cloud"]
            # keep numpy's scalar dtype (f32 for f32 clouds): the height
            # subtraction must round exactly like the per-item path
            floor = (
                np.percentile(pc[:, 2], 0.99)
                if self.use_height else np.float32(0.0)
            )
            sem_ok = np.ascontiguousarray(
                np.isin(scene["semantic_labels"], list(NYU40_IDS)), np.uint8
            )
            got = (floor, sem_ok)
            self._scene_statics_cache[scene_id] = got
        return got

    def batch_layout(self) -> dict:
        """Shapes/dtypes of the big per-item arrays ((shape, dtype) per
        key). BatchIterator preallocates (B, ...) batch buffers from this
        and passes per-item slot views to get_item(out=...), so the wide
        arrays (~95% of batch bytes) are written once, in place — no
        collate-time np.stack memcpy."""
        if self._c_out is None:
            scene = self.scene_source(
                self.chunks[0][0]["scene_id"], self.split
            )
            self._c_out = int(scene["point_cloud"].shape[1]) + (
                1 if self.use_height else 0
            )
        n = self.num_points
        return {
            "point_clouds": ((n, self._c_out), np.float32),
            "vote_label": ((n, 9), np.float32),
            "vote_label_mask": ((n,), np.int64),
            "instance_labels": ((n,), np.int64),
        }

    def __getitem__(self, idx: int) -> dict:
        return self.get_item(idx)

    def get_item(self, idx: int, out: dict | None = None) -> dict:
        # counter-based per-item stream keyed on (seed, epoch round, idx):
        # deterministic AND independent of loader worker count / item
        # evaluation order (a shared sequential Generator would make the
        # stream depend on thread interleaving; torch's per-worker seeding
        # makes the reference's stream depend on num_workers instead)
        rng = np.random.default_rng((self.seed, self._shuffle_round, idx))
        chunk = self.chunks[idx]
        istrain = 1 if self.split == "train" else 0
        lang_num = len(chunk)
        scene_id = chunk[0]["scene_id"]
        scene = self.scene_source(scene_id, self.split)

        # sentence slots (pad by repeating the last annotation); with
        # minor_aug, a minor-class sentence occupies the following slot too
        object_id_list, object_name_list, ann_id_list, text_list = [], [], [], []
        add_last_minor = False
        cursor = 0
        for i in range(self.lang_num_max - self.lang_num_aug):
            if istrain and self.minor_aug and add_last_minor:
                add_last_minor = False  # repeat previous entry (slot reuse)
            else:
                data = chunk[min(cursor, lang_num - 1)]
                cursor += 1
            object_id_list.append(int(data["object_id"]))
            name = " ".join(data["object_name"].split("_"))
            object_name_list.append(name)
            ann_id_list.append(int(data["ann_id"]))
            text_list.append(" ".join(data["token"]))
            if istrain and self.minor_aug and name in self.minor_label:
                add_last_minor = True

        # Fused native path: the wide work (C_out-column row gather, vote
        # regen, instance gather) runs in C, written straight into the
        # caller's batch-buffer slots; only the NARROW columns the augment
        # chain touches (xyz, col 3, height) are replayed in f64 numpy with
        # the exact per-item op sequence — bit-identical to the numpy path
        # below (which mirrors dataset.py:596-679 including its f64
        # promotion after the height concat).
        scene_pc = scene["point_cloud"]
        instance_bboxes = np.array(scene["instance_bboxes"], np.float32)
        use_fused = (
            native.native_available()
            and isinstance(scene_pc, np.ndarray)
            and scene_pc.dtype == np.float32
            and scene_pc.flags.c_contiguous
        )

        if use_fused:
            c_raw = scene_pc.shape[1]
            c_out = c_raw + (1 if self.use_height else 0)
            floor_height, sem_ok_raw = self._scene_statics(scene_id, scene)
            replace = scene_pc.shape[0] < self.num_points
            choices = np.ascontiguousarray(
                rng.choice(scene_pc.shape[0], self.num_points,
                           replace=replace),
                np.int64,
            )
            if out is not None:
                point_cloud = out["point_clouds"]
                instance_labels = out["instance_labels"]
                point_votes = out["vote_label"]
                point_votes_mask = out["vote_label_mask"]
            else:
                point_cloud = np.empty((self.num_points, c_out), np.float32)
                instance_labels = np.empty((self.num_points,), np.int64)
                point_votes = np.empty((self.num_points, 9), np.float32)
                point_votes_mask = np.empty((self.num_points,), np.int64)
            native.gather_i64(
                scene["instance_labels"], choices, instance_labels
            )
            sem_ok = native.gather_u8(sem_ok_raw, choices)
            # the point gather itself runs fused with the augmentation
            # below (native.gather_augment_rows) once the augmentation
            # params are drawn
        else:
            point_cloud = np.array(scene_pc, np.float32)
            instance_labels = np.array(scene["instance_labels"])
            semantic_labels = np.array(scene["semantic_labels"])

            if self.use_height:
                floor_height = np.percentile(point_cloud[:, 2], 0.99)
                height = point_cloud[:, 2] - floor_height
                point_cloud = np.concatenate(
                    [point_cloud, height[:, None]], axis=1
                )

            replace = point_cloud.shape[0] < self.num_points
            choices = rng.choice(
                point_cloud.shape[0], self.num_points, replace=replace
            )
            point_cloud = point_cloud[choices]
            instance_labels = instance_labels[choices]
            semantic_labels = semantic_labels[choices]

        # GT boxes padded to MAX_NUM_OBJ
        num_bbox = min(instance_bboxes.shape[0], MAX_NUM_OBJ)
        target_bboxes = np.zeros((MAX_NUM_OBJ, 6), np.float32)
        target_bboxes_mask = np.zeros((MAX_NUM_OBJ,), np.float32)
        target_bboxes[:num_bbox] = instance_bboxes[:num_bbox, 0:6]
        target_bboxes_mask[:num_bbox] = 1.0

        if use_fused:
            # ONE C pass: sample-gather + flip/rotate/scale/translate +
            # height channel (loader.c:gather_augment_rows), bit-identical
            # to the numpy path below — the numpy augment chain rounds to
            # f32 at each step's store, and the kernel replays exactly
            # those rounding points (augment.py:apply_augment_points
            # documents the arithmetic contract). Box transforms + the
            # rng draws stay in numpy (draw_augment — reference order).
            params = None
            if self.augment:
                params, target_bboxes = draw_augment(rng, target_bboxes)
            native.gather_augment_rows(
                scene_pc, choices, point_cloud,
                params=params, use_height=self.use_height,
                floor_height=floor_height,
            )
        elif self.augment:
            point_cloud, target_bboxes = augment_scene(
                point_cloud, target_bboxes, self.use_height, rng
            )

        # votes AFTER augmentation (dataset.py:669-678); single-pass native
        # C kernel when a compiler is available, numpy loop otherwise
        if use_fused:
            native.compute_votes_tiled(
                point_cloud, instance_labels, sem_ok,
                point_votes, point_votes_mask,
            )
        else:
            sem_ok = np.isin(semantic_labels, list(NYU40_IDS))
            if native.native_available():
                point_votes, point_votes_mask = native.compute_votes(
                    point_cloud[:, :3], instance_labels, sem_ok
                )
            else:
                point_votes = np.zeros((self.num_points, 3), np.float32)
                point_votes_mask = np.zeros(self.num_points, np.float32)
                for i_instance in np.unique(instance_labels):
                    ind = np.where(instance_labels == i_instance)[0]
                    if sem_ok[ind[0]]:
                        x = point_cloud[ind, :3]
                        center = 0.5 * (x.min(0) + x.max(0))
                        point_votes[ind, :] = center - x
                        point_votes_mask[ind] = 1.0
            point_votes = np.tile(point_votes, (1, GT_VOTE_FACTOR))

        angle_classes = np.zeros((MAX_NUM_OBJ,), np.int64)
        angle_residuals = np.zeros((MAX_NUM_OBJ,), np.float32)
        size_classes = np.zeros((MAX_NUM_OBJ,), np.int64)
        size_residuals = np.zeros((MAX_NUM_OBJ, 3), np.float32)
        class_ind = [
            self.nyu40id2class.get(int(x), 0)
            for x in instance_bboxes[:num_bbox, -2]
        ]
        size_classes[:num_bbox] = class_ind
        size_residuals[:num_bbox] = (
            target_bboxes[:num_bbox, 3:6] - self.mean_size_arr[class_ind]
        )

        # prompt-augmented synthetic sentences (dataset.py:689-725)
        for _ in range(self.lang_num_aug):
            anns = self.scanrefer_dict[scene_id]
            if len(anns) >= 2:
                while True:
                    ri = rng.choice(len(anns), size=2, replace=False)
                    target_id = int(anns[ri[0]]["object_id"])
                    anchor_id = int(anns[ri[1]]["object_id"])
                    if target_id != anchor_id:
                        break
                t_center = a_center = np.zeros(3)
                for i, gid in enumerate(instance_bboxes[:num_bbox, -1]):
                    if int(gid) == target_id:
                        t_center = instance_bboxes[i, 0:3]
                    if int(gid) == anchor_id:
                        a_center = instance_bboxes[i, 0:3]
                t_name = " ".join(anns[ri[0]]["object_name"].split("_"))
                a_name = " ".join(anns[ri[1]]["object_name"].split("_"))
                text = self.prompt.get_prompt(
                    t_name, t_center, a_name, a_center, rng
                )
                object_id_list.append(target_id)
                object_name_list.append(t_name)
                # "augmented annotation always set to the first
                # annotation" (dataset.py:718-719): the reference takes
                # the first ann key of the target object, NOT the
                # sampled annotation's own ann_id
                first_ann = next(
                    iter(
                        self.unique_multiple.get(scene_id, {}).get(
                            str(target_id), {int(anns[ri[0]]["ann_id"]): 0}
                        )
                    )
                )
                ann_id_list.append(int(first_ann))
                text_list.append(text)
            else:  # degenerate scene: repeat the real annotation
                object_id_list.append(object_id_list[-1])
                object_name_list.append(object_name_list[-1])
                ann_id_list.append(ann_id_list[-1])
                text_list.append(text_list[-1])

        # per-sentence ref labels (dataset.py:728-765). Deliberate
        # non-port: when a sentence's object_id matches NO gt box, the
        # reference appends nothing for that slot, shifting every later
        # sentence's labels left and padding the tail with stale values
        # (dataset.py:755-763) — a label/sentence misalignment. We keep
        # slot alignment (unmatched slots stay zero). Equivalent on the
        # filtered ScanRefer jsons, where every annotated object carries
        # an exported gt box.
        l = self.lang_num_max
        ref_box_label_list = np.zeros((l, MAX_NUM_OBJ), np.int64)
        ref_center_list = np.zeros((l, 3), np.float32)
        ref_size_class_list = np.zeros((l,), np.int64)
        ref_size_residual_list = np.zeros((l, 3), np.float32)
        for j in range(l):
            for i, gid in enumerate(instance_bboxes[:num_bbox, -1]):
                if int(gid) == object_id_list[j]:
                    ref_box_label_list[j, i] = 1
                    ref_center_list[j] = target_bboxes[i, 0:3]
                    ref_size_class_list[j] = size_classes[i]
                    ref_size_residual_list[j] = size_residuals[i]

        ref_sizes = (
            self.mean_size_arr[ref_size_class_list] + ref_size_residual_list
        )
        ref_box_corner_list = np.asarray(
            get_3d_box_batch(ref_sizes, np.zeros((l,)), ref_center_list)
        )

        # all-GT corners (dataset.py:768-785); padding rows are zero in
        # the reference (corners computed for :num_bbox only) — keep that
        # exact, consumers also gate by gt_box_masks
        gt_sizes = self.mean_size_arr[size_classes] + size_residuals
        gt_corners = np.asarray(
            get_3d_box_batch(
                gt_sizes, np.zeros((MAX_NUM_OBJ,)), target_bboxes[:, 0:3]
            )
        )
        gt_corners[num_bbox:] = 0.0
        gt_box_masks = np.zeros((MAX_NUM_OBJ,), np.int64)
        gt_box_masks[:num_bbox] = 1
        gt_box_object_ids = np.zeros((MAX_NUM_OBJ,), np.int64)
        gt_box_object_ids[:num_bbox] = instance_bboxes[:num_bbox, -1]

        sem_cls_label = np.zeros((MAX_NUM_OBJ,), np.int64)
        sem_cls_label[:num_bbox] = class_ind

        object_cat_list = np.array(
            [self.raw2label.get(n, 17) for n in object_name_list], np.int64
        )
        unique_multiple_list = np.array(
            [
                self.unique_multiple.get(scene_id, {})
                .get(str(object_id_list[i]), {})
                .get(ann_id_list[i], 0)
                for i in range(l)
            ],
            np.int64,
        )

        bert = self.tokenizer(text_list, max_length=self.bert_max_len)

        # the four big direct-write arrays (batch_layout): already sitting
        # in `out` slots on the fused path; on the numpy path copy them in
        big = {
            "point_clouds": point_cloud if use_fused
            else point_cloud.astype(np.float32),
            "instance_labels": instance_labels if use_fused
            else instance_labels.astype(np.int64),
            "vote_label": point_votes if use_fused
            else point_votes.astype(np.float32),
            "vote_label_mask": point_votes_mask if use_fused
            else point_votes_mask.astype(np.int64),
        }
        if out is not None:
            if not use_fused:
                for k, v in big.items():
                    out[k][...] = v
            big = {}

        item = {
            "istrain": np.int32(istrain),
            "lang_num": np.int32(lang_num),
            **big,
            "center_label": target_bboxes[:, 0:3],
            "heading_class_label": angle_classes,
            "heading_residual_label": angle_residuals,
            "size_class_label": size_classes,
            "size_residual_label": size_residuals,
            "num_bbox": np.int64(num_bbox),
            "sem_cls_label": sem_cls_label,
            "box_label_mask": target_bboxes_mask,
            "scan_idx": np.int64(idx),
            "scene_id": scene_id,
            "gt_box_corner_label": gt_corners.astype(np.float64),
            "gt_box_masks": gt_box_masks,
            "gt_box_object_ids": gt_box_object_ids,
            # reference key name (dataset.py:837); caption eval gathers it
            # through object_assignment (eval_helper.py:186-197)
            "scene_object_ids": gt_box_object_ids,
            **self._rotation_fields(scene_id, gt_box_object_ids, num_bbox),
            "ref_box_label_list": ref_box_label_list,
            "ref_center_label_list": ref_center_list,
            "ref_heading_class_label_list": np.zeros((l,), np.int64),
            "ref_heading_residual_label_list": np.zeros((l,), np.int64),
            "ref_size_class_label_list": ref_size_class_list,
            "ref_size_residual_label_list": ref_size_residual_list,
            "ref_box_corner_label_list": ref_box_corner_list.astype(
                np.float64
            ),
            "object_id_list": np.array(object_id_list, np.int64),
            "ann_id_list": np.array(ann_id_list, np.int64),
            "object_cat_list": object_cat_list,
            "unique_multiple_list": unique_multiple_list,
            "input_ids": bert["input_ids"],
            "bert_attention_mask": bert["attention_mask"],
        }
        if self._glove_lang is not None:
            item.update(glove_batch_fields(
                chunk, self._glove_lang, self.lang_num_max, self.max_des_len))
        if self._cap_lang is not None:
            item.update(caption_batch_fields(
                chunk, self._cap_lang, self.lang_num_max, self.max_des_len))
        return item


def collate(items: list, *, random_gate: float, epoch: int) -> dict:
    """Stack per-item dicts into a batch; attach the shared step scalars
    (the reference's data_dict['random'] / ['epoch'] / ['istrain'])."""
    batch = {}
    for k, v in items[0].items():
        if isinstance(v, str):
            batch[k] = [it[k] for it in items]
        else:
            batch[k] = np.stack([it[k] for it in items])
    batch["istrain"] = batch["istrain"][0]
    batch["epoch"] = np.int32(epoch)
    batch["random"] = np.float32(random_gate)
    return batch


class BatchIterator:
    """Threaded prefetch loader (replaces torch DataLoader workers + the
    CUDA-stream Prefetcher, lib/joint/prefetcher.py).

    num_workers > 1 stripes batches across worker threads (batch b on
    worker b % W, consumed in order through per-worker bounded queues) —
    the numpy-heavy __getitem__ releases the GIL for most of its time,
    so workers scale on multi-core hosts like the reference's
    num_workers=4 DataLoader. The batch stream is IDENTICAL for any
    worker count: random gates are drawn for all batches upfront from
    the iterator's rng, and item order within a batch is fixed."""

    def __init__(self, dataset, batch_size: int, *, epoch: int = 0,
                 drop_last: bool = True, prefetch: int = 2,
                 num_workers: int = 1,
                 rng: np.random.Generator | None = None,
                 item_slice: "tuple[int, int] | None" = None):
        """item_slice=(start, k): build only rows [start, start+k) of
        every batch — the multi-host local-loading contract. Per-item
        randomness is counter-based (seed, shuffle round, idx) and the
        per-batch random gates are drawn for ALL batches upfront, so a
        process that builds only its k-row slice produces arrays
        bit-identical to rows [start:start+k] of the full batch; each
        host pays 1/n_proc of the loader work instead of building the
        whole global batch and slicing (the reference has no multi-host
        loader at all — torch DataLoader on one node, SURVEY §2.5)."""
        self.dataset = dataset
        self.batch_size = batch_size
        self.epoch = epoch
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = max(1, num_workers)
        self.rng = rng or np.random.default_rng(0)
        if item_slice is not None:
            s, k = item_slice
            if not (0 <= s and k >= 1 and s + k <= batch_size):
                raise ValueError(
                    f"item_slice {item_slice} out of range for "
                    f"batch_size {batch_size}"
                )
            if not drop_last:
                # a partial tail batch could leave this process's slice
                # empty (uncollatable); the multi-host train feed always
                # drops the tail, so reject the combination outright
                raise ValueError("item_slice requires drop_last=True")
        self.item_slice = item_slice

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _make_batch(self, b: int, gate: float):
        lo = b * self.batch_size
        hi = min((b + 1) * self.batch_size, len(self.dataset))
        if self.item_slice is not None:
            s, k = self.item_slice
            lo, hi = min(lo + s, hi), min(lo + s + k, hi)
        idxs = range(lo, hi)
        layout = getattr(self.dataset, "batch_layout", None)
        if layout is not None:
            # direct-write path: preallocate the big (B, ...) arrays and
            # hand per-item slot views to get_item — items never carry the
            # wide arrays and collate never re-copies them. Buffers come
            # from the native recycled pool when available (fresh ~170 MB
            # numpy allocations page-fault-storm every batch; loader.c)
            alloc = (
                native.alloc_array if native.native_available()
                else lambda s, d: np.empty(s, d)
            )
            big = {
                k: alloc((len(idxs),) + shape, dtype)
                for k, (shape, dtype) in layout().items()
            }
            items = [
                self.dataset.get_item(
                    i, {k: v[j] for k, v in big.items()}
                )
                for j, i in enumerate(idxs)
            ]
            batch = collate(items, random_gate=gate, epoch=self.epoch)
            batch.update(big)
            return batch
        items = [self.dataset[i] for i in idxs]
        return collate(items, random_gate=gate, epoch=self.epoch)

    def __iter__(self):
        import threading

        n_batches = len(self)
        # one draw per batch, in batch order — worker count cannot
        # change the stream
        gates = [float(self.rng.random()) for _ in range(n_batches)]
        w = min(self.num_workers, max(n_batches, 1))

        # Ordered shared buffer with a bounded in-flight WINDOW: worker
        # of batch b waits until b < consumed + prefetch + w. Total
        # built-but-unconsumed batches never exceeds prefetch + w
        # (per-worker queues would multiply buffering by num_workers —
        # ~2 GB of batches at canonical multiview shapes), and the
        # window guarantees progress: the next batch to be consumed is
        # always inside it. Worker exceptions are re-raised in the
        # consumer instead of hanging it.
        cond = threading.Condition()
        buf: dict = {}
        state = {"consumed": 0, "error": None}

        def worker(wid: int):
            try:
                for b in range(wid, n_batches, w):
                    with cond:
                        while (
                            b >= state["consumed"] + self.prefetch + w
                            and state["error"] is None
                        ):
                            cond.wait()
                        if state["error"] is not None:
                            return
                    item = self._make_batch(b, gates[b])
                    with cond:
                        buf[b] = item
                        cond.notify_all()
            except BaseException as e:  # surface in the consumer
                with cond:
                    state["error"] = e
                    cond.notify_all()

        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True)
            for i in range(w)
        ]
        for t in threads:
            t.start()
        for b in range(n_batches):
            with cond:
                while b not in buf and state["error"] is None:
                    cond.wait()
                if state["error"] is not None:
                    raise state["error"]
                item = buf.pop(b)
                state["consumed"] = b + 1
                cond.notify_all()
            yield item
