"""Scan2CAD alignment -> per-instance rotation matrices.

The port's own copy of ``vlp3d/data/scan2cad.py``, after
`scripts/captioning_scripts/Scan2CAD_to_ScanNet.py`: every CAD
model aligned into a scan carries a rotation quaternion; map each to the
ScanNet instance id it annotates (via aligned_cad2inst_id.json) and emit
{scene_id: {instance_id: 3x3 rotation matrix}} — the orientation
supervision the 3DJCG-era captioning pipelines can consume.

Quaternion convention: Scan2CAD stores (w, x, y, z), the same order
np.quaternion(*rotation) consumed in the reference (:35-36).
"""

from __future__ import annotations

import numpy as np


def quaternion_to_matrix(q) -> np.ndarray:
    """(w, x, y, z) quaternion -> 3x3 rotation matrix (normalized)."""
    w, x, y, z = (float(v) for v in q)
    n = (w * w + x * x + y * y + z * z) ** 0.5
    if n == 0:
        return np.eye(3)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


def parse_scan2cad_rotations(
    annotations: list[dict], cad2inst: dict
) -> dict:
    """full_annotations.json entries + aligned_cad2inst_id.json ->
    {scene_id: {instance_id: rotation matrix as nested lists}}.

    CAD models with no instance mapping are skipped, as in the
    reference's KeyError pass (:33-42)."""
    parsed: dict = {}
    for scan in annotations:
        scene_id = scan["id_scan"]
        for cad_id, cad in enumerate(scan.get("aligned_models", [])):
            try:
                instance_id = cad2inst[scene_id][str(cad_id)]
            except KeyError:
                continue
            rot = quaternion_to_matrix(cad["trs"]["rotation"])
            parsed.setdefault(scene_id, {})[instance_id] = rot.tolist()
    return parsed
