"""Offline ScanNet preprocessing, and the layout check the scene loader
runs.

The port's own copy of ``vlp3d/data/scannet.py`` (after the reference's
`data/scannet/{batch_load_scannet_data,load_scannet_data,
scannet_utils}.py`): per scan, read the `_vh_clean_2.ply` mesh +
aggregation / segment jsons + axis-align matrix, produce
  {scene}_vert.npy            (N, 9) xyz + rgb + face normals
  {scene}_aligned_vert.npy    (N, 9) axis-aligned xyz + rgb + normals
                              (normals computed pre-alignment, as the
                              reference does: aligned_vertices copies
                              cols 3:9, load_scannet_data.py:66-71)
  {scene}_sem_label.npy       (N,) nyu40 ids
  {scene}_ins_label.npy       (N,) instance ids (1-based, 0 = none)
  {scene}_bbox.npy            (K, 8) cx cy cz dx dy dz nyu40_id obj_id
  {scene}_aligned_bbox.npy    (K, 8)
capped at 50k points (MAX_NUM_POINT, batch_load_scannet_data.py:17), with
wall/floor/ceiling points kept but boxes restricted to the 37 detection
nyu40 ids (OBJ_CLASS_IDS). The PLY reader is self-contained (binary
little-endian + ascii).

`build_preprocess` then fuses per-point features (color / normal /
multiview) into the `{scene}_preprocess_{split}.npy` cache consumed by the
joint dataset (lib/joint/dataset.py:598-601 expects these caches). The
multiview features are read from their hdf5 by
:func:`vlp3d_torch.data.hdf5.read_datasets`, without h5py.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

MAX_NUM_POINT = 50000
# per-channel RGB dataset mean (scripts/preprocess/point_cloud.py:10)
MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8], dtype=np.float64)
DONOTCARE_CLASS_IDS = np.array([])
OBJ_CLASS_IDS = np.array(
    [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
     23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40]
)

_PLY_TYPES = {
    "char": ("b", 1), "uchar": ("B", 1), "int8": ("b", 1), "uint8": ("B", 1),
    "short": ("h", 2), "ushort": ("H", 2), "int16": ("h", 2),
    "uint16": ("H", 2), "int": ("i", 4), "int32": ("i", 4),
    "uint": ("I", 4), "uint32": ("I", 4), "float": ("f", 4),
    "float32": ("f", 4), "double": ("d", 8), "float64": ("d", 8),
}


_PLY_NP = {
    "char": "i1", "uchar": "u1", "int8": "i1", "uint8": "u1",
    "short": "<i2", "ushort": "<u2", "int16": "<i2", "uint16": "<u2",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
}


def read_ply_mesh_arrays(path: str):
    """ONE pass over a PLY (binary_little_endian / ascii): returns
    (vertex dict as in read_ply_vertices, faces (F, 3) int64).
    Vertices parse via a structured np.frombuffer (no per-row python
    loop); exporting a full scan previously parsed the file twice."""
    with open(path, "rb") as f:
        fmt = None
        elements = []  # (name, count, props); list props as ('list', ct, it, name)
        cur = None
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, cnt = line.split()
                cur = (name, int(cnt), [])
                elements.append(cur)
            elif line.startswith("property") and cur is not None:
                parts = line.split()
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[2], parts[1]))
            elif line == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian"):
            raise ValueError(f"unsupported ply format {fmt}")

        verts: dict = {}
        faces: list = []
        for name, cnt, props in elements:
            is_list = any(p[0] == "list" for p in props)
            if name == "vertex":
                if is_list:
                    raise ValueError("list property in vertex element")
                pnames = [p[0] for p in props]
                if fmt == "ascii":
                    rows = [
                        [float(x) for x in f.readline().split()[: len(props)]]
                        for _ in range(cnt)
                    ]
                    data = np.asarray(rows, np.float64)
                    verts = {n: data[:, i] for i, n in enumerate(pnames)}
                else:
                    dt = np.dtype([(n, _PLY_NP[t]) for n, t in props])
                    raw = f.read(dt.itemsize * cnt)
                    rec = np.frombuffer(raw, dtype=dt, count=cnt)
                    verts = {
                        n: rec[n].astype(np.float64) for n in pnames
                    }
                verts["_names"] = pnames
            elif name == "face" and is_list:
                _, count_t, idx_t, _pn = props[0]
                if fmt == "ascii":
                    for _ in range(cnt):
                        vals = f.readline().split()
                        k = int(vals[0])
                        faces.append([int(x) for x in vals[1:1 + k]])
                else:
                    cf = "<" + _PLY_TYPES[count_t][0]
                    csz = struct.calcsize(cf)
                    isz = struct.calcsize("<" + _PLY_TYPES[idx_t][0])
                    for _ in range(cnt):
                        (k,) = struct.unpack(cf, f.read(csz))
                        idx = struct.unpack(
                            "<" + _PLY_TYPES[idx_t][0] * k, f.read(isz * k)
                        )
                        faces.append(list(idx))
            else:  # skip any other element
                if fmt == "ascii":
                    for _ in range(cnt):
                        f.readline()
                elif is_list:
                    raise ValueError(f"cannot skip binary list element {name}")
                else:
                    rec = "<" + "".join(_PLY_TYPES[t][0] for _, t in props)
                    f.read(struct.calcsize(rec) * cnt)
    return verts, np.asarray(faces, np.int64) if faces else np.zeros(
        (0, 3), np.int64
    )


def read_ply_vertices(path: str) -> dict:
    """Minimal PLY vertex reader (binary_little_endian / ascii)."""
    return read_ply_mesh_arrays(path)[0]


def read_ply_faces(path: str) -> np.ndarray:
    """Face indices (F, 3) from a PLY's face element (list property).

    Supports ascii and binary_little_endian with the standard
    `list uchar int vertex_indices` layout.
    """
    return read_ply_mesh_arrays(path)[1]


def write_ply_mesh(path: str, vertices: np.ndarray, faces: np.ndarray):
    """Write an ascii PLY mesh; vertices (N, 6) xyz+rgb, faces (F, 3)."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        for name in ("x", "y", "z"):
            f.write(f"property float {name}\n")
        for name in ("red", "green", "blue"):
            f.write(f"property uchar {name}\n")
        f.write(f"element face {len(faces)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        for v in vertices:
            f.write(
                f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f} "
                f"{int(v[3])} {int(v[4])} {int(v[5])}\n"
            )
        for face in faces:
            f.write("3 " + " ".join(str(int(i)) for i in face) + "\n")


def align_vertices(vertices: np.ndarray, axis_align: np.ndarray) -> np.ndarray:
    """Apply the scene meta's axisAlignment to xyz columns (the export's
    aligned-mesh transform, export_scannet_axis_aligned_mesh.py:62-71)."""
    out = np.array(vertices, np.float64, copy=True)
    hom = np.concatenate(
        [out[:, :3], np.ones((len(out), 1))], axis=1
    )
    out[:, :3] = (hom @ axis_align.T)[:, :3]
    return out


def read_mesh_vertices_rgb(path: str) -> np.ndarray:
    v = read_ply_vertices(path)
    return np.stack(
        [v["x"], v["y"], v["z"], v["red"], v["green"], v["blue"]], axis=1
    ).astype(np.float32)


def read_axis_align_matrix(meta_path: str) -> np.ndarray | None:
    with open(meta_path) as f:
        for line in f:
            if line.startswith("axisAlignment"):
                vals = [float(x) for x in line.split("=")[1].split()]
                return np.asarray(vals, np.float64).reshape(4, 4)
    return None


def read_label_map(tsv_path: str, label_from="raw_category", label_to="nyu40id"):
    mapping = {}
    with open(tsv_path, encoding="utf-8") as f:
        header = f.readline().rstrip("\n").split("\t")
        i_from, i_to = header.index(label_from), header.index(label_to)
        for line in f:
            el = line.rstrip("\n").split("\t")
            mapping[el[i_from]] = int(el[i_to]) if el[i_to] else 0
    return mapping


def export_scan(
    mesh_file: str,
    agg_file: str,
    seg_file: str,
    meta_file: str,
    label_map: dict,
) -> dict:
    """One scan -> vertex arrays + instance boxes (load_scannet_data.export).

    Vertices are (N, 9) xyz + rgb + face-accumulated normals, matching
    scannet_utils.read_mesh_vertices_rgb_normal (load_scannet_data.py:57)
    — the canonical --use_normal training run consumes cols 6:9."""
    v, faces = read_ply_mesh_arrays(mesh_file)  # one parse for both
    mesh_vertices = np.stack(
        [v["x"], v["y"], v["z"], v["red"], v["green"], v["blue"]], axis=1
    ).astype(np.float32)
    # f32 end-to-end: the reference's normal path is float32 (np.array
    # over float32 scalars infers float32, scannet_utils.py:113)
    mesh_vertices = np.concatenate(
        [
            mesh_vertices,
            compute_vertex_normals(mesh_vertices[:, :3], faces),
        ],
        axis=1,
    )

    axis_align = read_axis_align_matrix(meta_file)
    pts = np.ones((mesh_vertices.shape[0], 4))
    pts[:, :3] = mesh_vertices[:, :3]
    aligned = mesh_vertices.copy()
    if axis_align is not None:
        aligned[:, :3] = (pts @ axis_align.T)[:, :3]

    with open(seg_file) as f:
        seg_to_verts: dict = {}
        seg_indices = json.load(f)["segIndices"]
        for vi, seg in enumerate(seg_indices):
            seg_to_verts.setdefault(seg, []).append(vi)

    with open(agg_file) as f:
        seg_groups = json.load(f)["segGroups"]

    n = mesh_vertices.shape[0]
    sem_label = np.zeros(n, np.int64)
    ins_label = np.zeros(n, np.int64)
    object_ids = []
    object_sems = []
    for group in seg_groups:
        label = label_map.get(group["label"], 0)
        verts = [
            vi for seg in group["segments"] for vi in seg_to_verts.get(seg, [])
        ]
        verts = np.asarray(verts, np.int64)
        sem_label[verts] = label
        ins_label[verts] = group["objectId"] + 1
        object_ids.append(group["objectId"])
        object_sems.append(label)

    def instance_boxes(vertices):
        boxes = []
        for oid, sem in zip(object_ids, object_sems):
            m = ins_label == oid + 1
            if not m.any():
                continue
            xyz = vertices[m, :3]
            mn, mx = xyz.min(0), xyz.max(0)
            boxes.append(
                np.concatenate(
                    [(mn + mx) / 2, mx - mn, [sem], [oid]]
                )
            )
        return (
            np.stack(boxes).astype(np.float32)
            if boxes
            else np.zeros((0, 8), np.float32)
        )

    return {
        "mesh_vertices": mesh_vertices,
        "aligned_vertices": aligned,
        "semantic_labels": sem_label,
        "instance_labels": ins_label,
        "instance_bboxes": instance_boxes(mesh_vertices),
        "aligned_instance_bboxes": instance_boxes(aligned),
    }


def export_one_scan(scannet_dir, scan_name, label_map, output_prefix,
                    rng=None):
    """batch_load_scannet_data.export_one_scan: filter DONOTCARE points,
    keep boxes of OBJ_CLASS_IDS, subsample to 50k, save the 6 npys."""
    base = os.path.join(scannet_dir, scan_name, scan_name)
    data = export_scan(
        base + "_vh_clean_2.ply",
        base + ".aggregation.json",
        base + "_vh_clean_2.0.010000.segs.json",
        base + ".txt",
        label_map,
    )
    mask = np.logical_not(
        np.isin(data["semantic_labels"], DONOTCARE_CLASS_IDS)
    )
    mesh_vertices = data["mesh_vertices"][mask]
    aligned_vertices = data["aligned_vertices"][mask]
    semantic_labels = data["semantic_labels"][mask]
    instance_labels = data["instance_labels"][mask]

    bboxes = data["instance_bboxes"]
    aligned_bboxes = data["aligned_instance_bboxes"]
    if bboxes.shape[0] > 1:
        keep = np.isin(bboxes[:, -2], OBJ_CLASS_IDS)
        bboxes = bboxes[keep]
        aligned_bboxes = aligned_bboxes[keep]

    n = mesh_vertices.shape[0]
    if n > MAX_NUM_POINT:
        rng = rng or np.random.default_rng(0)
        choices = rng.choice(n, MAX_NUM_POINT, replace=False)
        mesh_vertices = mesh_vertices[choices]
        aligned_vertices = aligned_vertices[choices]
        semantic_labels = semantic_labels[choices]
        instance_labels = instance_labels[choices]

    np.save(output_prefix + "_vert.npy", mesh_vertices)
    np.save(output_prefix + "_aligned_vert.npy", aligned_vertices)
    np.save(output_prefix + "_sem_label.npy", semantic_labels)
    np.save(output_prefix + "_ins_label.npy", instance_labels)
    np.save(output_prefix + "_bbox.npy", bboxes)
    np.save(output_prefix + "_aligned_bbox.npy", aligned_bboxes)


def build_preprocess(
    data_dir: str,
    scene_id: str,
    split: str,
    *,
    use_color: bool = False,
    use_normal: bool = True,
    multiview_path: str | None = None,
    output_dir: str | None = None,
):
    """Fuse per-point features into {scene}_preprocess_{split}.npy:
    [xyz, (rgb-mean)/256?, normal 3, multiview 128] — normals BEFORE
    multiview, matching the reference's fuse order
    (scripts/preprocess/point_cloud.py:41-47) and hence the relation
    module's hard-coded multiview slice at channel 6 under the canonical
    flags (relation_module.py:101: point_clouds[..., 6:6+128]); the
    height channel is appended at load time by the dataset."""
    output_dir = output_dir or data_dir
    vert = np.load(os.path.join(data_dir, scene_id + "_aligned_vert.npy"))
    xyz = vert[:, :3]
    feats = [xyz]
    if use_color:
        # per-channel dataset mean (scripts/preprocess/point_cloud.py:10)
        feats.append((vert[:, 3:6] - MEAN_COLOR_RGB) / 256.0)
    if use_normal:
        if vert.shape[1] >= 9:
            # exporter-stored face normals (scannet_utils.py:97-117);
            # the reference's preprocess reads these cols directly
            # (scripts/preprocess/point_cloud.py:41-43)
            feats.append(vert[:, 6:9])
        else:
            # legacy 6-col exports: fall back to kNN-PCA estimation
            feats.append(estimate_normals(xyz))
    if multiview_path:
        from vlp3d_torch.data.hdf5 import read_datasets

        feats.append(np.asarray(read_datasets(multiview_path)[scene_id]))
    out = np.concatenate(feats, axis=1).astype(np.float32)
    np.save(
        os.path.join(output_dir, f"{scene_id}_preprocess_{split}.npy"), out
    )
    np.save(
        os.path.join(output_dir, f"{scene_id}_pcl_color_{split}.npy"),
        vert[:, 3:6].astype(np.float32),
    )
    return out


def check_preprocess_layout(point_cloud: np.ndarray, path: str = "") -> None:
    """Detect stale `_preprocess_*.npy` caches written with the old fuse
    order [xyz, color?, multiview, normal] (normals LAST). The current
    order is [xyz, color?, normal, multiview] (normals before multiview,
    build_preprocess above); both layouts have identical shapes, so a
    stale cache would silently feed multiview channels into the relation
    module's channel-6 slice. Heuristic: face-accumulated normals are
    (near-)unit or zero vectors, multiview activations are not. Raises
    only when the expected block clearly fails AND the trailing block
    clearly passes."""
    width = point_cloud.shape[1]
    if width == 134:  # xyz + normal(3) + multiview(128)
        expect = point_cloud[:, 3:6]
    elif width == 137:  # xyz + color(3) + normal(3) + multiview(128)
        expect = point_cloud[:, 6:9]
    else:
        return

    def unit_or_zero_frac(block):
        n = np.linalg.norm(block, axis=1)
        return float(np.mean((np.abs(n - 1.0) < 0.05) | (n < 1e-6)))

    def strictly_unit_frac(block):
        # zero rows deliberately NOT counted: dead post-ReLU multiview
        # channels are all-zero and must not pass as "normals" (a valid
        # [xyz, color, multiview] width-134 cache would otherwise be
        # rejected when its trailing ENet channels are dead)
        n = np.linalg.norm(block, axis=1)
        return float(np.mean(np.abs(n - 1.0) < 0.05))

    if (unit_or_zero_frac(expect) < 0.5
            and strictly_unit_frac(point_cloud[:, -3:]) > 0.9):
        raise ValueError(
            f"stale preprocess cache {path or '(array)'}: normals found in "
            "the trailing columns (old fuse order [xyz, color?, multiview, "
            "normal]); regenerate with vlp3d-preprocess / "
            "scannet.build_preprocess, which writes [xyz, color?, normal, "
            "multiview]"
        )


def compute_vertex_normals(xyz: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Per-vertex normals from face normals (scannet_utils.py:18-45).

    Semantics notes, both preserved deliberately:
      * normalization divides by (len + 1e-8) with no zero guard;
      * accumulation uses buffered fancy indexing (`out[idx] += n` with
        duplicate idx keeps only the LAST contribution per statement,
        NOT a sum — np.add.at would differ). Each corner column
        contributes at most one face normal per vertex.
    """
    out = np.zeros(xyz.shape, dtype=xyz.dtype)
    if len(faces) == 0:
        return out
    tris = xyz[faces]
    fn = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])

    def _unit(a):
        lens = np.sqrt(a[:, 0] ** 2 + a[:, 1] ** 2 + a[:, 2] ** 2)
        for c in range(3):
            a[:, c] /= lens + 1e-8
        return a

    fn = _unit(fn)
    for c in range(3):
        out[faces[:, c]] += fn  # buffered: last duplicate wins
    return _unit(out)


def estimate_normals(xyz: np.ndarray, k: int = 10) -> np.ndarray:
    """kNN-PCA normal estimation (the reference consumes normals
    precomputed by the upstream 3DVL_Codebase step; this computes them
    from scratch). O(N*k) via grid-bucketed neighbour search."""
    n = xyz.shape[0]
    if n < k + 1:
        return np.tile([0.0, 0.0, 1.0], (n, 1)).astype(np.float32)
    # coarse chunked brute force: fine for offline preprocessing
    normals = np.zeros((n, 3), np.float32)
    chunk = 2048
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d2 = ((xyz[s:e, None, :] - xyz[None, :, :]) ** 2).sum(-1)
        idx = np.argpartition(d2, k, axis=1)[:, :k]
        nbrs = xyz[idx]  # (c, k, 3)
        centered = nbrs - nbrs.mean(1, keepdims=True)
        cov = np.einsum("cki,ckj->cij", centered, centered)
        _, vecs = np.linalg.eigh(cov)
        normals[s:e] = vecs[:, :, 0]
    return normals
