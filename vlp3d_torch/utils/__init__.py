"""Host-side helpers of the trainer: phase timers, device memory, and the
TensorBoard and wandb writers."""
