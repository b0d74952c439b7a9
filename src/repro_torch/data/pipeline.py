"""Sharded, prefetching, exactly-resumable data pipeline (a numpy copy of
``repro/data/pipeline.py``).

The paper's data path (Alg 4 line 1: every node reads its own shard; line
10: each worker samples from local memory) maps to: each pod consumes a
disjoint deterministic shard of the stream, keyed by (seed, step, pod), so
 * no two pods ever see the same batch at the same step,
 * restart from a checkpointed ``step`` reproduces the exact batch sequence
   (no cursor files needed — the cursor IS the step),
 * elastic rescale (pods joining/leaving) just changes ``n_shards``.

A background thread prefetches ``depth`` batches ahead (the paper's
'asynchronously copies b samples' — overlap of data movement with compute).
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class PipelineState:
    step: int


class ShardedPipeline:
    """Wraps a ``batch_at(step) -> dict`` source with pod-stacking and
    prefetch. ``source_factory(shard, n_shards)`` builds one shard's
    stream."""

    def __init__(self, source_factory: Callable, n_pods: int = 1,
                 depth: int = 2, start_step: int = 0):
        self.factory = source_factory
        self.n_pods = n_pods
        self.depth = depth
        self.state = PipelineState(step=start_step)
        self.sources = [source_factory(i, n_pods) for i in range(n_pods)]
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._next_produce = start_step

    def _produce(self, step: int):
        shards = [s.batch_at(step) for s in self.sources]
        return {
            k: np.stack([sh[k] for sh in shards], axis=0)
            for k in shards[0]
        }

    def _worker(self):
        while not self._stop.is_set():
            step = self._next_produce
            batch = self._produce(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    self._next_produce = step + 1
                    break
                except queue.Full:
                    continue

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()
        return self

    def next(self):
        """Next batch, stacked (n_pods, B, ...). Prefetched if started."""
        if self._thread is None:
            batch = self._produce(self.state.step)
            self.state.step += 1
            return batch
        step, batch = self._q.get()
        # if a restore rewound the cursor, regenerate deterministically
        if step != self.state.step:
            batch = self._produce(self.state.step)
        self.state.step += 1
        return batch

    def restore(self, step: int):
        self.state.step = step
        self._next_produce = step
        # drain stale prefetch
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None

    def rescale(self, n_pods: int):
        """Elastic pod count change: re-shard the stream (DESIGN.md §8)."""
        self.stop()
        self._stop = threading.Event()
        self.n_pods = n_pods
        self.sources = [self.factory(i, n_pods) for i in range(n_pods)]
        self.restore(self.state.step)
