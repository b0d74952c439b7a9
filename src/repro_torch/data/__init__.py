"""Synthetic datasets and the sharded, prefetching pipeline."""
