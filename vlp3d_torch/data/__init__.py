from vlp3d_torch.data.synthetic import (
    make_batch,
    make_synthetic_dataset,
    tiny_config,
)

__all__ = ["make_batch", "make_synthetic_dataset", "tiny_config"]
