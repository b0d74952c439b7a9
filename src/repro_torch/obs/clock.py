"""Worker↔master clock offset for trace merging, NTP style (the port of
``repro/obs/clock.py``).

A worker sends an empty CLOCK probe at local t0; the master echoes its
``time.perf_counter()`` t_m; the worker notes t1. Under symmetric delay
the master read the probe at (t0 + t1) / 2 local time, so

    offset = t_m − (t0 + t1) / 2,      master ≈ local + offset,

with error at most rtt/2. The sample at the minimum round trip is kept.
On one host ``perf_counter`` is CLOCK_MONOTONIC, system-wide, so the
estimate is ≈ 0, bounded by the loopback rtt.
"""
from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class ClockSync:
    """``offset_s``: add to local times to land on the master clock;
    ``rtt_s``: the minimum observed round trip (|offset error| ≤ rtt/2)."""

    offset_s: float
    rtt_s: float
    probes: int

    def to_wire(self) -> dict:
        return {"offset_s": self.offset_s, "rtt_s": self.rtt_s,
                "probes": self.probes}


def combine(samples: list) -> ClockSync:
    """``[(t0_local, t_master, t1_local)]`` -> the min-rtt estimate."""
    best_rtt, offset = float("inf"), 0.0
    for t0, tm, t1 in samples:
        rtt = t1 - t0
        if rtt < best_rtt:
            best_rtt = rtt
            offset = tm - (t0 + t1) / 2.0
    return ClockSync(offset_s=offset, rtt_s=best_rtt, probes=len(samples))


def sync_over_link(link, wid: int = 0, probes: int = 8) -> ClockSync:
    """Probe over a ``net.wire.Link`` whose peer echoes CLOCK frames with
    ``{"t": perf_counter()}`` (the master's per-link reader does)."""
    from repro_torch.net import wire
    samples = []
    for _ in range(probes):
        t0 = time.perf_counter()
        link.send_simple(wire.CLOCK, wid=wid)
        frame = link.recv_header()
        if frame.ftype != wire.CLOCK:
            raise wire.WireError(f"expected a CLOCK reply, got {frame}")
        tm = float(link.recv_json(frame)["t"])
        samples.append((t0, tm, time.perf_counter()))
    return combine(samples)


def answer(link, frame, wid: int = 0) -> None:
    """The echo half: consume one CLOCK probe and reply with this clock."""
    from repro_torch.net import wire
    link.recv_discard(frame)
    link.send_json(wire.CLOCK, {"t": time.perf_counter()}, wid=wid)
