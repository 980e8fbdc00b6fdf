"""Command-line entry points (``python -m eop_tpu_torch.tools.<name>``)."""
