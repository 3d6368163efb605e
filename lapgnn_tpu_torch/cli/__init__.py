"""Command-line entry points (python -m lapgnn_tpu_torch.cli.<tool>)."""
