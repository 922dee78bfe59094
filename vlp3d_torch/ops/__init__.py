"""Point-cloud ops: FPS, ball query, grouping, three-NN interpolation.

FPS, ball query, three-NN and the row gather (with its scatter-add
backward) run hand-written CUDA kernels on CUDA tensors and their plain
PyTorch versions on CPU tensors. Index outputs carry no gradient.
"""

from vlp3d_torch.ops._kernels import launches, reset_launches
from vlp3d_torch.ops.ball_query import (
    ball_query,
    ball_query_with_count,
    query_and_group,
)
from vlp3d_torch.ops.grouping import gather_points, group_points
from vlp3d_torch.ops.interpolate import (
    interpolate_features,
    three_interpolate,
    three_nn,
)
from vlp3d_torch.ops.sampling import furthest_point_sample

__all__ = [
    "ball_query",
    "ball_query_with_count",
    "query_and_group",
    "gather_points",
    "group_points",
    "three_nn",
    "three_interpolate",
    "interpolate_features",
    "furthest_point_sample",
    "launches",
    "reset_launches",
]
