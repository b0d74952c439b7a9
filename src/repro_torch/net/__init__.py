"""The tcp transport of the PS runtime (the port of ``repro/net``): the
framed wire (``wire``), the worker↔worker data plane (``peer``), the
gradient worker process (``worker``) and the master server (``server``).
Registered as ``transport="tcp"`` in ``ps.transport``; orchestrated across
hosts by ``launch.cluster``. Modules import on first use."""
import importlib

__all__ = ["peer", "server", "wire", "worker"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"repro_torch.net.{name}")
    raise AttributeError(f"module 'repro_torch.net' has no attribute "
                         f"{name!r}")
