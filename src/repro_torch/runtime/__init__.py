"""The multi-pod training step and the serving steps."""
