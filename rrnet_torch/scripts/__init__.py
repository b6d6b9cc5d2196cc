"""Command-line entry points (`python -m rrnet_torch.scripts.<name>`)."""
