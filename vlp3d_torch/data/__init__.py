from vlp3d_torch.data.synthetic import make_batch, tiny_config

__all__ = ["make_batch", "tiny_config"]
