"""Count the work one traced step does: the port's counterpart of
``repro/launch/hloparse.py``.

The reference parses a step's compiled HLO. The port has no compiled
program to parse: it counts the ops a step dispatches while it runs, on
real tensors or on fake ones (``torch._subclasses.FakeTensorMode``), as
an ``OpCounter`` (a ``TorchDispatchMode``). Eager torch runs its loops,
so every op is seen as often as it runs and no trip counts are needed.

* FLOPs: ``torch.utils.flop_counter``'s formulas for the products
  (``mm``, ``addmm``, ``bmm``, ``baddbmm``, convolutions): 2·M·N·K a
  product;
* bytes: the inputs and outputs of every op that is not a view (the HBM
  proxy of ``hloparse``, whose fusions the port does not have);
* kernel regions: each call of a hand-written kernel's wrapper
  (``utils.opcount_hook.kernel_region``) counts the kernel's work from
  ``core.costmodel`` once, its operations as FLOPs, and none of the ops
  inside it, so the count is the card's work whichever path runs; its
  calls are counted by name (``launches``). With ``stand_ins=True`` a
  region does not run its wrapper: it makes the kernel's outputs (and a
  scratch buffer the kernel's wrapper holds while it runs), uninitialised.
  A step on fake tensors needs that (a plain version branches on values
  that fake tensors do not have), and its memory is then what the card
  holds: the kernels' outputs, not a plain version's temporaries;
* collectives: each ``torch.distributed`` call of the port reports itself
  (``utils.opcount_hook.collective``): bytes and counts by kind and by
  dtype, and a collective whose group spans ranks of different pods
  (``pod_stride`` ranks a pod) counts as cross-pod.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections import defaultdict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.utils import opcount_hook

aten = torch.ops.aten

# the product ops whose FLOPs are counted
_PRODUCTS = {p: flop_registry[p] for p in (
    aten.mm, aten.addmm, aten.bmm, aten.baddbmm, aten.convolution,
    aten._convolution, aten.convolution_backward)}

_PRODUCT_OPS = {op for p in _PRODUCTS for op in
                (getattr(p, name) for name in p.overloads())}

# ops that move no bytes of their own: allocation and aliasing
_FREE = {"empty", "empty_strided", "empty_like", "new_empty",
         "new_empty_strided", "detach", "lift_fresh", "alias",
         "_local_scalar_dense", "set_"}

_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.float64: "f64",
                torch.int8: "s8", torch.uint8: "u8", torch.int32: "s32",
                torch.int64: "s64", torch.bool: "pred"}


@dataclasses.dataclass
class OpCosts:
    """``hloparse.HloCosts``' fields for one rank's step, without
    ``while_trip_counts``; ``regions`` holds each kernel region's calls,
    bytes and operations by wrapper name."""
    flops: float
    bytes: float
    collective_bytes: float
    bytes_by_collective: dict
    counts_by_collective: dict
    cross_pod_bytes: float = 0.0
    collective_bytes_by_dtype: dict = dataclasses.field(default_factory=dict)
    cross_pod_bytes_by_dtype: dict = dataclasses.field(default_factory=dict)
    regions: dict = dataclasses.field(default_factory=dict)

    @property
    def launches(self) -> dict:
        """Calls of each kernel region."""
        return {k: r["launches"] for k, r in self.regions.items()}


@functools.cache
def _composite(func) -> bool:
    """True for an aten op defined by its decomposition (and not one of
    the counted products)."""
    return (func.namespace == "aten" and func not in _PRODUCT_OPS
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), torch._C.DispatchKey.CompositeImplicitAutograd))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class OpCounter(TorchDispatchMode):
    """Count what runs inside ``with OpCounter(...) as c:``; read
    ``c.costs()`` after. ``pod_stride``: ranks a pod (0: no cross-pod
    accounting); ``stand_ins``: kernel regions make their outputs instead
    of running (module docstring)."""

    def __init__(self, pod_stride: int = 0, stand_ins: bool = False):
        super().__init__()
        self.pod_stride = pod_stride
        self.stand_ins = stand_ins
        self.flops = 0.0
        self.bytes = 0.0
        self._depth = 0
        self._regions = defaultdict(lambda: {"launches": 0, "bytes": 0.0,
                                             "operations": 0.0})
        self._coll = defaultdict(float)
        self._coll_n = defaultdict(int)
        self._coll_dt = defaultdict(float)
        self._cross = 0.0
        self._cross_dt = defaultdict(float)
        self._prevs = []        # the counters this one replaced, entered

    def __enter__(self):
        self._prevs.append(opcount_hook.set_active(self))
        return super().__enter__()

    def __exit__(self, *exc):
        opcount_hook.set_active(self._prevs.pop())
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # a composite op (einsum, matmul, ...) reaches the mode whole
            # where autograd is off (``inference_mode``): count what it
            # decomposes into, as a step with autograd on shows it
            with self:
                return func.decompose(*args, **kwargs)
        out = func(*args, **kwargs)
        if self._depth == 0 and not func.is_view \
                and func.namespace != "prim" \
                and func._overloadpacket.__name__ not in _FREE:
            formula = _PRODUCTS.get(func._overloadpacket)
            if formula is not None:
                self.flops += formula(*args, **kwargs, out_val=out)
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in _tensors(out))
        return out

    @contextlib.contextmanager
    def region(self, name: str, work: tuple):
        """One call of kernel ``name`` doing ``work = (bytes,
        operations)``; the ops inside are not counted. A region inside
        another counts nothing of its own."""
        if self._depth == 0:
            n_bytes, n_ops = work
            r = self._regions[name]
            r["launches"] += 1
            r["bytes"] += n_bytes
            r["operations"] += n_ops
            self.bytes += n_bytes
            self.flops += n_ops
        self._depth += 1
        try:
            yield
        finally:
            self._depth -= 1

    def _crosses_pods(self, group) -> bool:
        if not self.pod_stride:
            return False
        ranks = (range(dist.get_world_size()) if group is None
                 else dist.get_process_group_ranks(group))
        return len({r // self.pod_stride for r in ranks}) > 1

    def collective(self, kind: str, tensor, group=None) -> None:
        b = _nbytes(tensor)
        dt = _DTYPE_NAMES.get(tensor.dtype, str(tensor.dtype))
        self._coll[kind] += b
        self._coll_n[kind] += 1
        self._coll_dt[dt] += b
        if self._crosses_pods(group):
            self._cross += b
            self._cross_dt[dt] += b

    def costs(self) -> OpCosts:
        return OpCosts(
            flops=self.flops, bytes=self.bytes,
            collective_bytes=sum(self._coll.values()),
            bytes_by_collective=dict(self._coll),
            counts_by_collective=dict(self._coll_n),
            cross_pod_bytes=self._cross,
            collective_bytes_by_dtype=dict(self._coll_dt),
            cross_pod_bytes_by_dtype=dict(self._cross_dt),
            regions={k: dict(v) for k, v in self._regions.items()})
