from vlp3d_torch.losses.joint import compute_joint_loss

__all__ = ["compute_joint_loss"]
