"""Command-line drivers of the port (``python -m computervision_codes_tpu_torch.cli.<driver>``)."""
