"""Training drivers (``python -m umnn_tpu_torch.examples.<name>``)."""
