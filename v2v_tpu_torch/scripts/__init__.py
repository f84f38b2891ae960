"""The port's experiment scripts: `python -m v2v_tpu_torch.scripts.<name>`."""
