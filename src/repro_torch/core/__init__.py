"""Optimizer math and the α–β cost model."""
