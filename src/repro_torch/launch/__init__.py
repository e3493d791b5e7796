"""Launch entry points (run as ``python -m repro_torch.launch.serve``)."""
