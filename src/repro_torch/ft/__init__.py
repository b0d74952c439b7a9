"""Fault tolerance: the preemption watchdog."""
from repro_torch.ft.watchdog import Watchdog

__all__ = ["Watchdog"]
