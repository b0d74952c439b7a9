"""Checkpoint/restart: atomic, async, keep-N, preemption-safe (the port of
``repro/checkpoint/manager.py``).

The on-disk layout is the reference's, so a checkpoint written by either
package restores into the other (f32 states):

    <dir>/step_<12 digits>/{meta.json, arrays.npz}

``arrays.npz`` holds ``leaf_<i>`` in the reference ``ElasticState``'s leaf
order (``core.elastic.state_leaves``: step, then the params, momentum,
center and error-feedback leaves, each per-pod leaf ``(P, *shape)``). A
step is written to a temporary directory and renamed (atomic on POSIX);
``save_async`` copies the state to the host at once and writes it on a
background thread, so the train loop never blocks on disk. ``meta.json``
keeps the reference's keys; its ``treedef`` is a description, since the
port has no JAX treedef (the reference's restore does not read it).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core import elastic

TREEDEF = ("repro_torch ElasticState(step, params, momentum, center, "
           "ef_error) leaves in jax.tree_util order")


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._last_error: Optional[BaseException] = None

    # -- write ---------------------------------------------------------------
    def save(self, step: int, state: elastic.ElasticState,
             extra: Optional[dict] = None):
        """Blocking atomic save."""
        self._write(step, elastic.state_leaves(state), extra or {})

    def save_async(self, step: int, state: elastic.ElasticState,
                   extra: Optional[dict] = None):
        """Non-blocking: copy to the host now, write on a background
        thread."""
        self.wait()
        leaves = elastic.state_leaves(state)   # before training mutates it
        self._thread = threading.Thread(
            target=self._write_safe, args=(step, leaves, extra or {}),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._last_error is not None:
            err, self._last_error = self._last_error, None
            raise err

    def _write_safe(self, step, leaves, extra):
        try:
            self._write(step, leaves, extra)
        except BaseException as e:  # surfaced on next wait()
            self._last_error = e

    def _write(self, step: int, leaves: list, extra: dict):
        tmp = os.path.join(self.dir, f".tmp_step_{step}_{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:012d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{f"leaf_{i}": x for i, x in enumerate(leaves)})
        meta = {
            "step": step,
            "time": time.time(),
            "n_leaves": len(leaves),
            "treedef": TREEDEF,
            "extra": extra,
        }
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)           # atomic publish
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:012d}"),
                          ignore_errors=True)

    # -- read ----------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in sorted(os.listdir(self.dir)):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: elastic.ElasticState,
                step: Optional[int] = None):
        """Restore into the layout, dtypes and device of ``template``.
        Returns ``(state, meta)``."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:012d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            leaves = [_bf16_bits(data[f"leaf_{i}"])
                      for i in range(meta["n_leaves"])]
        return elastic.state_from_leaves(template, leaves), meta


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """A bf16 leaf the reference wrote comes back from ``np.load`` as raw
    2-byte records without ml_dtypes; widen it to f32 (exact)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        bits = a.view(np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32)
    return a
