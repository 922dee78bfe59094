"""vlp3d_torch: the PyTorch + CUDA port of vlp3d for NVIDIA Hopper.

Slice 1 covers ScanRefer grounding inference: the PointNet++ backbone
(hand-written CUDA kernels for furthest point sampling, ball query and
three-NN under ``csrc/``), voting, proposals, relation, the frozen BERT
text encoder, the match head and :class:`~vlp3d_torch.serving.
GroundingPredictor`. Activations are channels-last (B, N, C), as in the
JAX package; weights load from the reference-layout state dict
(:func:`vlp3d_torch.convert.jax_to_torch_state_dict`).
"""

from vlp3d_torch.config import Config, DatasetConfig, ModelConfig
from vlp3d_torch.device import resolve_device

__all__ = ["Config", "DatasetConfig", "ModelConfig", "resolve_device"]
