"""Command-line entry points (`python -m edgegan_torch.cli.train`)."""
