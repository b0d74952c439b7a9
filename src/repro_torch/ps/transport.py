"""The thread transport of the PS runtime (the port of
``repro/ps/transport.py``: ``PSContext`` and ``ThreadTransport``).

Workers are ``threading.Thread``s in this process. The master state is a
set of f64 tensors on the run's device, shared by every thread, so an
in-place update is the publication. All threads launch on PyTorch's one
current stream: the host barriers then order the device work as they
order the reference's numpy work.
"""
from __future__ import annotations

import threading
from types import SimpleNamespace

import torch


class Slot:
    """A shared mutable cell (mirrors mp.RawValue's ``.value``)."""

    __slots__ = ("value",)

    def __init__(self, value=0):
        self.value = value


class PSContext:
    """Everything a worker needs: config, the shared tensors, the problem,
    the exchange rounds and the synchronisation primitives (set as
    attributes from ``prims``)."""

    def __init__(self, cfg, easgd, n, buffers, problem, rounds, prims,
                 boundaries=None):
        self.cfg = cfg
        self.easgd = easgd
        self.n = n
        self.buffers = buffers
        self.problem = problem          # the built (w0, grad_fn, eval_fn)
        self.rounds = rounds            # sync-family message rounds
        self.boundaries = boundaries    # bucket cuts over the padded row,
        #                                 or None for a monolithic exchange
        self.errors: list = []          # exceptions of failed threads
        for k, v in prims.items():
            setattr(self, k, v)

    def views(self) -> SimpleNamespace:
        return SimpleNamespace(**self.buffers)

    def fail(self, exc: BaseException) -> None:
        """Record a thread's failure and break the barriers, so no other
        thread waits for it."""
        self.errors.append(exc)
        for b in (self.barrier, self.start_barrier):
            b.abort()


def _worker_entry(ctx: PSContext, worker_id: int):
    from repro_torch.ps import runtime
    try:
        runtime.worker_main(ctx, worker_id)
    except threading.BrokenBarrierError:
        pass                             # a peer or the launcher broke it;
        #                                  run_ps reports the cause
    except Exception as e:               # noqa: BLE001 — surfaced by run_ps
        ctx.fail(e)


class ThreadTransport:
    name = "thread"

    def __init__(self, device: torch.device):
        self.device = device

    def array(self, *shape):
        return torch.zeros(shape, dtype=torch.float64, device=self.device)

    def int_slot(self):
        return Slot()

    def barrier(self, parties):
        return threading.Barrier(parties)

    def launch(self, ctx: PSContext):
        handles = [
            threading.Thread(target=_worker_entry, args=(ctx, i), daemon=True)
            for i in range(ctx.cfg.n_workers)
        ]
        for h in handles:
            h.start()
        return handles

    def join(self, handles, timeout=None):
        for h in handles:
            h.join(timeout)
        return not any(h.is_alive() for h in handles)
