from vlp3d_torch.geometry.boxes import (
    box3d_diou,
    box3d_iou_aabb,
    box3d_iou_corners,
    corner_offsets_flat,
    get_3d_box_batch,
    rotate_rotz_rows,
)
from vlp3d_torch.geometry.nn_distance import huber_loss, nn_distance

__all__ = ["box3d_diou", "box3d_iou_aabb", "box3d_iou_corners",
           "corner_offsets_flat", "get_3d_box_batch", "rotate_rotz_rows",
           "huber_loss", "nn_distance"]
