from vlp3d_torch.models.jointnet import JointNet, init_weights_

__all__ = ["JointNet", "init_weights_"]
