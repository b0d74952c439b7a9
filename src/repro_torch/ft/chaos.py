"""Deterministic fault injection for the tcp runtime (a copy of
``repro/ft/chaos.py``; bad fields raise ``ValueError`` here).

Every failure path the membership machinery handles must be reproducible in
a test: this module turns "a worker dies at iteration k" into configuration.
A :class:`ChaosSpec` rides ``PSConfig.chaos`` on the master, is serialized
into the spawned worker's environment (``REPRO_CHAOS`` JSON), and the worker
*self-inflicts* the failure — ``os.kill(os.getpid(), SIGKILL/SIGTERM)`` at a
step boundary — so no supervisor process or timing race is involved:

* ``signal="kill"``  — SIGKILL: the socket drops mid-run, the master sees a
  dead link / process exit (the DEAD path).
* ``signal="term"``  — SIGTERM: ``ft.Watchdog`` catches it and the worker
  departs with a clean ``preempted`` BYE (the LEFT path).
* ``dial_refuse_s`` — the worker's HELLO dial is synthetically refused for
  the first window seconds (``wire.dial_with_backoff``'s ``refuse_fn``),
  exercising the retry satellite without a real staggered start.

Imported by the tcp worker on its start-up path.
"""
from __future__ import annotations

import json
import os
import signal as _signal
import time
from dataclasses import asdict, dataclass

ENV_VAR = "REPRO_CHAOS"
SIGNALS = ("kill", "term")


@dataclass(frozen=True)
class ChaosSpec:
    wid: int                      # the worker the fault targets
    kill_at_iter: int = -1        # self-signal at the first step >= this (-1 = never)
    signal: str = "kill"          # "kill" (SIGKILL) | "term" (clean preemption)
    dial_refuse_s: float = 0.0    # refuse the HELLO dial for this long

    def __post_init__(self):
        if self.signal not in SIGNALS:
            raise ValueError(f"chaos signal {self.signal!r} (one of "
                             f"{SIGNALS})")
        if self.dial_refuse_s < 0.0:
            raise ValueError(f"dial_refuse_s={self.dial_refuse_s}")

    def to_env(self) -> str:
        return json.dumps(asdict(self))

    @staticmethod
    def from_env(env: dict | None = None) -> "ChaosSpec | None":
        raw = (env if env is not None else os.environ).get(ENV_VAR)
        if not raw:
            return None
        return ChaosSpec(**json.loads(raw))

    @staticmethod
    def from_config(chaos) -> "ChaosSpec | None":
        """Normalize ``PSConfig.chaos`` (a ChaosSpec or a plain dict)."""
        if chaos is None:
            return None
        if isinstance(chaos, ChaosSpec):
            return chaos
        return ChaosSpec(**dict(chaos))


class ChaosClock:
    """The worker-side trigger: armed from ``REPRO_CHAOS`` at startup.

    ``maybe_fire(wid, step)`` is called at step boundaries; on the targeted
    worker at the targeted step it raises the configured signal against the
    calling process and (for SIGKILL) never returns. The dial-refuse window
    starts at construction time — i.e. worker process start — which is what
    a staggered launch looks like.
    """

    def __init__(self, spec: ChaosSpec | None):
        self.spec = spec
        self._t0 = time.monotonic()

    def refuse_dial(self, wid: int) -> bool:
        s = self.spec
        return (s is not None and s.wid == wid and s.dial_refuse_s > 0.0
                and (time.monotonic() - self._t0) < s.dial_refuse_s)

    def maybe_fire(self, wid: int, step: int) -> None:
        s = self.spec
        if s is None or s.wid != wid or s.kill_at_iter < 0:
            return
        if step >= s.kill_at_iter:
            signo = (_signal.SIGKILL if s.signal == "kill"
                     else _signal.SIGTERM)
            os.kill(os.getpid(), signo)
            # SIGTERM: the Watchdog handler runs; the loop notices at its
            # next watchdog check. Disarm so the signal fires exactly once.
            self.spec = None


def clock_from_env(env: dict | None = None) -> ChaosClock:
    return ChaosClock(ChaosSpec.from_env(env))
