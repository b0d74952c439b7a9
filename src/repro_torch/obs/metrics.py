"""Schedule-level exchange accounting (the port of ``count_round`` from
``repro/obs/metrics.py``)."""
from __future__ import annotations


def count_round(counters, rnd, n_elements: int) -> None:
    """One executed message round costs one sync_round, len(rnd) messages
    and Σ frac·n·8 logical wire bytes — invariant under bucketing, which
    repartitions frames, not messages. ``counters`` maps names to cells
    with a ``.value``."""
    counters["sync_rounds"].value += 1
    counters["messages"].value += len(rnd)
    counters["wire_bytes"].value += int(
        sum(m.frac for m in rnd) * n_elements * 8)
