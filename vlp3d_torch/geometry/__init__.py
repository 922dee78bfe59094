from vlp3d_torch.geometry.boxes import corner_offsets_flat, rotate_rotz_rows

__all__ = ["corner_offsets_flat", "rotate_rotz_rows"]
