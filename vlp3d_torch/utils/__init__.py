"""Host-side helpers: the trainer's phase timers, device memory, and the
TensorBoard and wandb writers; the scene and box dumps for viewers
(``visualize``); the post-mortem debugger hook (``postmortem``, which
installs itself when imported)."""
