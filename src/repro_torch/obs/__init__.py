"""Runtime accounting."""
