"""The multi-pod training step."""
