"""Models of the paper's experiments."""
