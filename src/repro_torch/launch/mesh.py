"""Device meshes over ``torch.distributed`` (the port of
``repro/launch/mesh.py``).

Single pod: ``(data=16, model=16)``; multi-pod: ``(pod=2, data=16,
model=16)``: the ``pod`` axis carries the EASGD elastic exchange,
``data`` and ``model`` stay inside a pod. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names, one process per device: CUDA meshes reduce over NCCL, CPU meshes
over gloo (``utils.device.resolve_device`` picks the device type).

These are functions, so importing the module touches no process group.
``init_world`` joins the world the process was launched in (``torchrun``'s
``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` environment), or makes a world
of one; a mesh whose size is not the world's raises.
"""
from __future__ import annotations

import math
import os

import torch
import torch.distributed as dist

from repro_torch.utils.device import resolve_device


def backend_for(device=None) -> str:
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_world(device=None) -> int:
    """Join the launched world (``torchrun``'s environment) or make a world
    of one, unless a default process group exists; returns its size. On
    CUDA the process takes the card ``LOCAL_RANK`` names."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend_for(dev), init_method="env://")
        else:
            dist.init_process_group(backend_for(dev), store=dist.HashStore(),
                                    rank=0, world_size=1)
    return dist.get_world_size()


def _make_mesh(shape: tuple, axes: tuple, device=None):
    from torch.distributed.device_mesh import init_device_mesh
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_world() first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs "
                         f"{math.prod(shape)} processes, the world has "
                         f"{world}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device)


def make_host_mesh(n_data: int = 2, n_model: int = 2, n_pods: int = 0,
                   device=None):
    """A small mesh over the world's processes — tests and examples."""
    if n_pods:
        return _make_mesh((n_pods, n_data, n_model),
                          ("pod", "data", "model"), device)
    return _make_mesh((n_data, n_model), ("data", "model"), device)


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh``, or of any object with the
    reference's ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.mesh.shape)))
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def n_pods_of(mesh) -> int:
    return axis_sizes(mesh).get("pod", 1)
