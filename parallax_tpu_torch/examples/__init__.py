"""Runnable examples of the port (``python -m parallax_tpu_torch.examples.<name>``)."""
