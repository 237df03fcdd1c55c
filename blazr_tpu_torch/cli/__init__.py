"""Command-line interface of the port (``python -m blazr_tpu_torch.cli``)."""
