"""Runtime observability (the port of ``repro/obs``): the counter registry
(``metrics``), the per-thread span recorder (``trace``), the worker↔master
clock offset (``clock``), the merged timeline with the Table-3 breakdown
(``report``), the live telemetry plane (``live``) and the BENCH_*.json
regression gate (``regress``). Turn tracing on with
``PSConfig(trace=True)``, the live plane with ``PSConfig(telemetry=True)``;
they come back on ``PSResult.trace`` and ``PSResult.health``.
"""
import importlib

__all__ = ["clock", "live", "metrics", "regress", "report", "trace"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
