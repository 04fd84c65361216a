"""Command-line entry points of the port (``python -m
planar_optical_flow_tpu_torch.cli.<name>``)."""
