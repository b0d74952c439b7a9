"""Timing on the card: CUDA events for kernels, a synchronising host clock
for steps. The counterpart of ``repro/utils/timing.py``, whose
``block_until_ready`` becomes ``torch.cuda.synchronize``: PyTorch returns
before the device has finished, so a host clock read without a
synchronise measures the enqueue, not the work.
"""
from __future__ import annotations

import statistics
import time

import torch


def synchronize(device=None) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def stream_sync(device):
    """A span clock's synchronise on the card: waits for the calling
    thread's current stream on ``device`` (None on the CPU, where work is
    done when the call returns)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return lambda: torch.cuda.current_stream(dev).synchronize()


class Timer:
    """Context manager measuring wall time; synchronises ``device`` on
    exit so the interval covers the device work enqueued inside it."""

    def __init__(self, device=None):
        self._device = device
        self.elapsed = 0.0

    def __enter__(self):
        synchronize(self._device)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        synchronize(self._device)
        self.elapsed = time.perf_counter() - self._t0
        return False


def cuda_time_ms(fn, *args, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of one ``fn(*args)`` call in milliseconds, each
    call bracketed by its own pair of CUDA events on the current stream."""
    for _ in range(warmup):
        fn(*args)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _device_of(out):
    """The device of the first tensor in ``out`` (a tensor, or a tuple,
    list or dict of them), or None."""
    if isinstance(out, torch.Tensor):
        return out.device
    items = out.values() if isinstance(out, dict) else \
        out if isinstance(out, (tuple, list)) else ()
    for x in items:
        dev = _device_of(x)
        if dev is not None:
            return dev
    return None


def time_fn(fn, *args, iters: int = 3, warmup: int = 1) -> float:
    """Best of ``iters`` host-clock seconds of ``fn(*args)``, each call
    followed by a synchronise of the device its first output tensor lies
    on (the reference's ``block_until_ready``)."""
    for _ in range(warmup):
        synchronize(_device_of(fn(*args)))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        synchronize(_device_of(fn(*args)))
        best = min(best, time.perf_counter() - t0)
    return best
