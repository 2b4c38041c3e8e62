"""The port's probe entry points: `python -m usdm_tpu_torch.scripts.<name>`."""
