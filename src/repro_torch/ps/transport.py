"""Transports of the PS runtime: who owns the shared tensors and how the
workers execute (the port of ``repro/ps/transport.py``).

* ``thread``  — workers are ``threading.Thread``s in this process. The
  master state is a set of f64 tensors on the run's device, shared by every
  thread, so an in-place update is the publication. All threads launch on
  PyTorch's one current stream, so the host lock, turnstile and barriers
  order the device work by ordering the launches. Hogwild runs the same
  absorb with no lock: on the card its calls interleave between kernels
  (each elementwise op is one kernel, atomic against the others on the
  stream), on the CPU between and within ops.
* ``process`` — workers are ``torch.multiprocessing`` processes started
  with ``spawn`` (never ``fork``). The tensors are shared: ``share_memory_``
  on the CPU, CUDA IPC of the launcher's allocations on the card (the
  launcher holds them until the workers have joined). Locks, conditions,
  barriers and ``RawValue`` slots come from the same context. Each process
  has its own CUDA context and stream, so host primitives no longer order
  device work: a worker calls ``ctx.fence()`` (a device synchronise)
  before it releases the lock, advances the turn, waits on a barrier or
  bumps a counter another process acts on. Problems must be a
  ``ProblemSpec``: each child rebuilds its gradient function on the run's
  device. Kernel launch counts live in each process; a worker adds its own
  to one shared slot per kernel as it exits, and ``run_ps`` folds them
  into ``kernels.launch_counts()``.
* ``tcp`` — workers are processes at the other end of real sockets
  (``net.worker``, spawned on localhost or joining from other hosts); the
  master server of ``net.server`` owns the whole run (``TcpTransport.run``).
"""
from __future__ import annotations

import threading
from types import SimpleNamespace

import torch
import torch.multiprocessing as tmp

from repro_torch.utils.device import resolve_device


class Slot:
    """A shared mutable cell (mirrors mp.RawValue's ``.value``)."""

    __slots__ = ("value",)

    def __init__(self, value=0):
        self.value = value


class PSContext:
    """Everything a worker needs, picklable for spawn: config, the shared
    tensors, the problem (a ``ProblemSpec``, or the built ``(w0, grad_fn,
    eval_fn)`` on the thread transport), the exchange rounds and the
    synchronisation primitives (set as attributes from ``prims``)."""

    def __init__(self, cfg, easgd, n, buffers, problem, rounds, prims,
                 device, boundaries=None, launch_slots=None):
        self.cfg = cfg
        self.easgd = easgd
        self.n = n
        self.buffers = buffers
        self.problem = problem
        self.rounds = rounds            # sync-family message rounds
        self.device = device
        self.boundaries = boundaries    # bucket cuts over the padded row,
        #                                 or None for a monolithic exchange
        self.launch_slots = launch_slots    # process transport: kernel name
        #                                     -> shared launch count
        # one CUDA context per process: host primitives order device work
        # only after a synchronise
        self.cross_process = (cfg.transport == "process"
                              and device.type == "cuda")
        self.errors: list = []          # exceptions of failed threads
        self._built = None
        for k, v in prims.items():
            setattr(self, k, v)

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_built"] = None
        d["errors"] = []
        return d

    def views(self) -> SimpleNamespace:
        return SimpleNamespace(**self.buffers)

    def built_problem(self):
        """(w0, grad_fn, eval_fn) — a ProblemSpec is built once per process
        on the run's device."""
        if self._built is None:
            p = self.problem
            self._built = p.build(self.device) if hasattr(p, "build") else p
        return self._built

    def fence(self) -> None:
        """Complete this process's device writes before a host primitive
        lets another process act on them (a no-op within one process)."""
        if self.cross_process:
            torch.cuda.synchronize(self.device)

    def fail(self, exc: BaseException) -> None:
        """Record a failure and break the barriers, so no one waits for the
        failed worker."""
        self.errors.append(exc)
        self.err.value = 1
        for b in (self.barrier, self.start_barrier):
            b.abort()


def _thread_entry(ctx: PSContext, worker_id: int):
    from repro_torch.ps import runtime
    try:
        runtime.worker_main(ctx, worker_id)
    except threading.BrokenBarrierError:
        pass                             # a peer or the launcher broke it;
        #                                  run_ps reports the cause
    except Exception as e:               # noqa: BLE001 — surfaced by run_ps
        ctx.fail(e)


def _process_entry(ctx: PSContext, worker_id: int):
    """Module-level so spawn can pickle the target. The traceback of a
    failure goes to this process's stderr and its exit code is non-zero;
    the launcher's watchdog sees it."""
    from repro_torch import kernels
    from repro_torch.ps import runtime
    if ctx.device.type == "cuda":
        torch.cuda.set_device(ctx.device)
    try:
        runtime.worker_main(ctx, worker_id)
        ctx.fence()
    except threading.BrokenBarrierError:
        pass
    except Exception as e:               # noqa: BLE001 — re-raised below
        ctx.fail(e)
        raise
    finally:
        with ctx.count_lock:
            for k, v in kernels.launch_counts().items():
                ctx.launch_slots[k].value += v
        # the process ends in os._exit, which runs no destructor: release
        # the shared tensors now, so the launcher's CUDA IPC blocks are
        # handed back
        ctx.buffers.clear()


class ThreadTransport:
    name = "thread"

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def array(self, *shape):
        return torch.zeros(shape, dtype=torch.float64, device=self.device)

    def int_slot(self):
        return Slot()

    def float_slot(self):
        return Slot(0.0)

    def lock(self):
        return threading.Lock()

    def condition(self):
        return threading.Condition()

    def barrier(self, parties):
        return threading.Barrier(parties)

    def launch(self, ctx: PSContext):
        handles = [
            threading.Thread(target=_thread_entry, args=(ctx, i), daemon=True)
            for i in range(ctx.cfg.n_workers)
        ]
        for h in handles:
            h.start()
        return handles

    def join(self, handles, timeout=None):
        for h in handles:
            h.join(timeout)
        return not any(h.is_alive() for h in handles)


class ProcessTransport:
    name = "process"

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._mp = tmp.get_context("spawn")

    def array(self, *shape):
        t = torch.zeros(shape, dtype=torch.float64, device=self.device)
        # CPU: shared memory; card: the allocation goes to the workers by
        # CUDA IPC when the context is pickled
        return t.share_memory_() if self.device.type == "cpu" else t

    def int_slot(self):
        return self._mp.RawValue("l", 0)

    def float_slot(self):
        return self._mp.RawValue("d", 0.0)

    def lock(self):
        return self._mp.Lock()

    def condition(self):
        return self._mp.Condition()

    def barrier(self, parties):
        return self._mp.Barrier(parties)

    def launch(self, ctx: PSContext):
        if not hasattr(ctx.problem, "build"):
            raise ValueError(
                "process transport needs a ProblemSpec (module:function), "
                "not prebuilt closures — children rebuild the problem")
        handles = [
            self._mp.Process(target=_process_entry, args=(ctx, i),
                             daemon=True)
            for i in range(ctx.cfg.n_workers)
        ]
        for h in handles:
            h.start()
        return handles

    def join(self, handles, timeout=None):
        for h in handles:
            h.join(timeout)
        alive = [h for h in handles if h.is_alive()]
        for h in alive:
            h.terminate()
            h.join(5.0)
        return not alive


class TcpTransport:
    """Workers are processes at the other end of TCP links; the master
    server (``net.server``) owns the whole run."""

    name = "tcp"

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def run(self, problem, easgd, cfg, join_timeout_s: float = 600.0):
        from repro_torch.net.server import run_ps_tcp
        return run_ps_tcp(problem, easgd, cfg, device=self.device,
                          join_timeout_s=join_timeout_s)


TRANSPORTS = {"thread": ThreadTransport, "process": ProcessTransport,
              "tcp": TcpTransport}


def get_transport(name: str, device=None):
    """A transport by name, on ``device`` (default: the card)."""
    try:
        cls = TRANSPORTS[name]
    except KeyError:
        raise ValueError(
            f"unknown transport '{name}', have {sorted(TRANSPORTS)}"
        ) from None
    return cls(device)
