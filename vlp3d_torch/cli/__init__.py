"""Command-line entry points of the port
(``python -m vlp3d_torch.cli.<name>``)."""
