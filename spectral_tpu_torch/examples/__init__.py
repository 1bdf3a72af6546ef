"""The port's example programs: the user's entry points of the
differentiable tier (``python -m spectral_tpu_torch.examples.<name>``)."""
