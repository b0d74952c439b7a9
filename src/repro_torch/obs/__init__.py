"""Runtime observability (the port of ``repro/obs``): the counter registry
(``metrics``), the per-thread span recorder (``trace``), the worker↔master
clock offset (``clock``) and the merged timeline with the Table-3
breakdown (``report``). Turn tracing on with ``PSConfig(trace=True)``; the
merged trace comes back on ``PSResult.trace`` with a ``report`` section.
"""
import importlib

__all__ = ["clock", "metrics", "report", "trace"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"repro_torch.obs.{name}")
    raise AttributeError(f"module 'repro_torch.obs' has no attribute "
                         f"{name!r}")
