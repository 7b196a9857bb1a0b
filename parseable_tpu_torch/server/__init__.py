"""HTTP server of the port (`python -m parseable_tpu_torch.server`)."""
