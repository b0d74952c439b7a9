"""Multi-pod Sync EASGD — the paper's Algorithm 4 on P pods (the port of
``repro/core/elastic.py``).

Each pod is one EASGD worker. Across pods, workers exchange *weights, not
gradients*, every ``tau`` steps through the elastic-averaging rules (paper
eqs. 1–2 / 5–6), with the paper's co-design techniques:

 1. **Packed single-buffer exchange** (§5.2). The state IS packed: the
    weights are a ``(P, n)`` tensor, one f32 row per pod, leaves in
    ``jax.tree_util`` order with the pods outer (``tfm.ravel_layout``);
    each pod's model parameters are views of its row. So packing and
    unpacking cost nothing, and the one reduction over pod rows
    (``comm.plan.ExchangePlan.reduce_mean_flat``) is the exchange.
 2. **Device-resident weights** (§6.1.2): all state lives on the card and
    the fused update (``kernels.elastic_update.fused_elastic_update``)
    runs on it in place, where the reference donates its buffers.
 3. **Compute/communication overlap** (§6.1.3): the exchange reads only
    the start-of-step weights W_t and center, so ``start_exchange`` can run
    it before the gradients. With ``overlap=True`` it runs on a second CUDA
    stream and the update waits on its event; with ``overlap=False`` it
    runs after the gradients on the one stream (the reference's
    ``optimization_barrier``). The bits are the same either way.

State: ``ElasticState`` holds ``params`` and ``momentum`` as ``(P, n)``
tensors, ``center`` as ``(n,)`` (None for msgd), ``ef_error`` as ``(P, n)``
f32 (compression only), ``step`` as a host integer (τ's branch never
synchronises), and the leaf ``shapes`` that cut the rows into the
reference's leaves (checkpoints, ``state_from_jax``).

On a mesh (``runtime.train.build_train_step(mesh=)``) each rank's state
holds its local pods' rows of its local shards, packed as the reference's
``_pack_local`` packs them (leaves in tree order, the pod dim outer), and
``shapes`` are the local leaf shapes. The plan then carries the ``pod``
axis's group: the local rows are summed and ONE collective runs over the
group (``comm.plan``), issued before the gradients with ``overlap`` and
waited on before the update, and the update runs unchanged on the local
rows with the total pod count. ``state_specs`` gives the reference's
PartitionSpecs; ``state_from_jax(..., mesh=, param_specs=)`` cuts a
reference state into the rank's shards and ``gather_state`` puts them
back together.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.comm import plan as comm_plan
from repro_torch.comm import schedules as comm_schedules
from repro_torch.core import compression as compression_lib
from repro_torch.core import costmodel
from repro_torch.core.easgd import EASGDConfig
from repro_torch.kernels import elastic_update as eu
from repro_torch.models.common import tree_leaves_with_path
from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    easgd: EASGDConfig = EASGDConfig()
    mode: str = "sync_easgd"        # "sync_easgd" | "msgd" (plain DP baseline)
    packed: bool = True             # paper §5.2: single-buffer exchange
    schedule: str = "psum"          # comm schedule of the pod-row reduction;
    #                                 "auto" picks via comm.choose at build
    compression: str = "none"       # none | bf16 | sign_ef (cross-pod only)
    overlap: bool = True            # paper §6.1.3 (Sync EASGD3)
    momentum_dtype: Any = torch.float32
    center_dtype: Any = torch.float32

    def __post_init__(self):
        if self.mode not in ("sync_easgd", "msgd"):
            raise ValueError(f"mode {self.mode!r} (sync_easgd or msgd)")
        if self.schedule != "auto":
            comm_schedules.get(self.schedule)   # validate
        compression_lib.get(self.compression)   # validate

    def resolve_schedule(self, n_total: int,
                         n_elements: int | None = None) -> str:
        """Resolve "auto" to a registry name via ``comm.choose`` on the
        post-compression bytes of the pod-row reduction, priced on
        ``costmodel.POD_EXCHANGE_NET`` (the network the reference prices
        it on), so that both resolve the same schedule. Without a buffer
        size, psum."""
        if self.schedule != "auto":
            return self.schedule
        if n_elements is None or n_total <= 1:
            return "psum"
        comp = compression_lib.get(self.compression)
        wire = n_elements * comp.jit_wire_bytes_per_element
        return comm_schedules.choose(wire, n_total,
                                     costmodel.POD_EXCHANGE_NET)

    def exchange_plan(self, n_total: int, n_elements: int | None = None,
                      group=None) -> comm_plan.ExchangePlan:
        """The fully-composed cross-pod exchange this config describes;
        ``group`` is the mesh's ``pod`` process group (None: every pod row
        local)."""
        return comm_plan.make_plan(
            schedule=self.resolve_schedule(n_total, n_elements),
            compression=self.compression, overlap=self.overlap,
            n_total=n_total, group=group)


@dataclasses.dataclass(frozen=True)
class ElasticState:
    step: int                         # host integer
    params: torch.Tensor              # (P, n) — local W⁽ⁱ⁾, pods outer
    momentum: torch.Tensor            # (P, n) — V⁽ⁱ⁾
    center: Optional[torch.Tensor]    # (n,) — W̄ (None for msgd)
    ef_error: Optional[torch.Tensor]  # (P, n) f32 (compression only)
    shapes: tuple = ()                # leaf shapes in row order

    def to(self, device) -> "ElasticState":
        """A copy of the state on ``device``."""
        move = (lambda t: None if t is None
                else t.to(device=device, copy=True))
        return dataclasses.replace(
            self, params=move(self.params), momentum=move(self.momentum),
            center=move(self.center), ef_error=move(self.ef_error))


def n_pods_of(state: ElasticState) -> int:
    return state.params.shape[0]


@dataclasses.dataclass
class PendingExchange:
    """The exchange of one step's start-of-step weights: the pod mean of W
    and the new error feedback, and the event the update waits on when the
    exchange ran on a second stream. On a pod group, ``finish`` waits on
    the collective and returns the two."""
    mean_w: Optional[torch.Tensor]
    ef_error: Optional[torch.Tensor]
    event: Optional[torch.cuda.Event] = None
    finish: Optional[Callable] = None


class StateSpecs(NamedTuple):
    """PartitionSpecs of an ``ElasticState``'s leaves, the reference's
    ``ElasticState`` of specs."""
    step: Any
    params: Any
    momentum: Any
    center: Any
    ef_error: Any


def state_specs(param_specs, cfg: ElasticConfig, pod_axis: str | None):
    """PartitionSpecs for the state given per-param specs (no pod dim):
    local (per-pod) tensors get a leading pod-axis entry; the center is
    replicated across pods."""
    from repro_torch.models.common import PartitionSpec, spec_tree_map
    params = spec_tree_map(lambda s: PartitionSpec(pod_axis, *s),
                           param_specs)
    center = None if cfg.mode == "msgd" else param_specs
    ef = params if (cfg.compression != "none" and cfg.mode != "msgd") \
        else None
    return StateSpecs(PartitionSpec(), params, params, center, ef)


# ---------------------------------------------------------------------------
# init and carrying state across
# ---------------------------------------------------------------------------

def init(params, cfg: ElasticConfig, n_pods: int = 1) -> ElasticState:
    """Broadcast one parameter pytree into per-pod local weights (paper
    Alg. 4 lines 4–7: broadcast W, create local and global copies)."""
    leaves = [leaf for _, leaf in tree_leaves_with_path(params)]
    dtypes = {leaf.dtype for leaf in leaves}
    if len(dtypes) != 1:
        raise ValueError(f"one packed row needs one param dtype, got {dtypes}")
    row = torch.cat([leaf.reshape(-1) for leaf in leaves])
    del leaves
    p, n, dev = n_pods, row.numel(), row.device
    momentum = torch.zeros((p, n), dtype=cfg.momentum_dtype, device=dev)
    center = (None if cfg.mode == "msgd"
              else row.to(cfg.center_dtype, copy=True))
    ef = (torch.zeros((p, n), dtype=torch.float32, device=dev)
          if cfg.compression != "none" and cfg.mode != "msgd" else None)
    shapes = tuple(tuple(leaf.shape) for _, leaf in
                   tree_leaves_with_path(params))
    return ElasticState(0, row[None].repeat(p, 1), momentum, center, ef,
                        shapes)


def _as_tensor(a, device) -> torch.Tensor:
    """A numpy array (f32, or the ml_dtypes bf16 JAX hands out) as a
    tensor of the same dtype on ``device``."""
    a = np.asarray(a)
    if a.dtype == np.float32 or a.dtype.kind in "iu":
        return torch.from_numpy(np.array(a)).to(device)      # a copy
    if a.dtype.name == "bfloat16":
        f32 = np.ascontiguousarray(a, dtype=np.float32)
        return torch.from_numpy(f32).to(device).to(torch.bfloat16)
    raise TypeError(f"unsupported dtype {a.dtype}")


def state_from_jax(ref_state, device=None, *, mesh=None,
                   param_specs=None) -> ElasticState:
    """Carry a reference ``ElasticState`` across: its ``step`` and its
    pytrees of (numpy or JAX) arrays, params, momentum and error feedback
    with a leading pod dim, packed into the port's rows (leaves in
    ``jax.tree_util`` order, pods outer). On a ``mesh`` each leaf is first
    cut to this rank's block: its pods by the ``pod`` axis, its dims by
    ``param_specs`` (``runtime.sharding.param_specs``). The reverse goes
    through a checkpoint (``checkpoint.CheckpointManager``)."""
    dev = resolve_device(device)
    n_leaves = len(tree_leaves_with_path(ref_state.params))
    specs, pod = [None] * n_leaves, None
    if mesh is not None:
        from repro_torch.models.common import spec_leaves
        from repro_torch.runtime import sharding
        specs = spec_leaves(param_specs)
        pod = "pod" if "pod" in sharding.mesh_axis_sizes(mesh) else None

    def cut(a, spec, pods: bool):
        a = np.asarray(a)
        if mesh is None:
            return a
        full = ((pod,) if pods else ()) + tuple(spec)
        return a[sharding.local_slices(mesh, a.shape, full)]

    def leaves_of(tree, pods: bool):
        return [cut(leaf, spec, pods) for (_, leaf), spec in
                zip(tree_leaves_with_path(tree), specs)]

    def rows(tree, pods: bool):
        if tree is None:
            return None
        leaves = [_as_tensor(a, dev) for a in leaves_of(tree, pods)]
        if pods:
            p = leaves[0].shape[0]
            return torch.cat([t.reshape(p, -1) for t in leaves], dim=1)
        return torch.cat([t.reshape(-1) for t in leaves])

    shapes = tuple(a.shape[1:] for a in leaves_of(ref_state.params, True))
    return ElasticState(int(np.asarray(ref_state.step)),
                        rows(ref_state.params, True),
                        rows(ref_state.momentum, True),
                        rows(ref_state.center, False),
                        rows(ref_state.ef_error, True), shapes)


def _leaf_views(t: torch.Tensor, shapes, pods: bool) -> list:
    """A packed row's leaves (``pods``: pod rows', each ``(P, *shape)``)
    as views."""
    out, off = [], 0
    for shape in shapes:
        size = math.prod(shape)
        out.append(t[:, off:off + size].reshape((t.shape[0],) + shape)
                   if pods else t[off:off + size].reshape(shape))
        off += size
    return out


def _relayout(state: ElasticState, mesh, param_specs, fn) -> ElasticState:
    """The state with ``fn(leaf, spec)`` applied to every leaf of every
    row (the pod rows' specs lead with the ``pod`` axis), packed again."""
    from repro_torch.models.common import PartitionSpec, spec_leaves
    from repro_torch.runtime import sharding
    specs = spec_leaves(param_specs)
    pod = "pod" if "pod" in sharding.mesh_axis_sizes(mesh) else None

    def leaves(t, pods: bool) -> list:
        return [fn(x, PartitionSpec(pod, *spec) if pods else spec)
                for x, spec in zip(_leaf_views(t, state.shapes, pods), specs)]

    def pack(xs, pods: bool):
        if pods:
            return torch.cat([x.reshape(x.shape[0], -1) for x in xs], dim=1)
        return torch.cat([x.reshape(-1) for x in xs])

    def one(t, pods: bool):
        return None if t is None else pack(leaves(t, pods), pods)

    params = leaves(state.params, True)
    return dataclasses.replace(
        state, params=pack(params, True), momentum=one(state.momentum, True),
        center=one(state.center, False), ef_error=one(state.ef_error, True),
        shapes=tuple(tuple(x.shape[1:]) for x in params))


def gather_state(state: ElasticState, mesh, param_specs) -> ElasticState:
    """The whole state from the ranks' shards, on every rank: every pod's
    rows of every leaf whole, in the one-device layout (each leaf gathered
    as a DTensor, ``runtime.sharding.gather_full``)."""
    from repro_torch.runtime import sharding
    return _relayout(state, mesh, param_specs, lambda x, spec: (
        sharding.gather_full(x.contiguous(), mesh, spec)))


def shard_state(full: ElasticState, mesh, param_specs) -> ElasticState:
    """This rank's block of a whole state (the inverse of
    ``gather_state``): its pods' rows of its shard of every leaf."""
    from repro_torch.runtime import sharding
    return _relayout(full, mesh, param_specs, lambda x, spec: (
        x[sharding.local_slices(mesh, x.shape, spec)]))


def state_leaves(state: ElasticState) -> list:
    """The state as the reference's ``ElasticState`` leaves, host numpy
    copies in ``jax.tree_util`` order: step, then every params leaf
    ``(P, *shape)``, momentum, center and error-feedback leaves. bf16
    leaves come out as f32 (numpy has no bf16; the values are exact)."""
    sizes = [math.prod(s) for s in state.shapes]
    out = [np.asarray(state.step, np.int32)]

    def cut(t, pods: bool):
        if t is None:
            return
        host = t.detach().to("cpu", copy=True)
        if host.dtype == torch.bfloat16:
            host = host.float()
        host = host.numpy()
        off = 0
        for size, shape in zip(sizes, state.shapes):
            if pods:
                out.append(host[:, off:off + size].reshape(
                    (host.shape[0],) + shape))
            else:
                out.append(host[off:off + size].reshape(shape))
            off += size

    cut(state.params, True)
    cut(state.momentum, True)
    cut(state.center, False)
    cut(state.ef_error, True)
    return out


def _leaf_shapes(state: ElasticState) -> list:
    """The shapes of ``state_leaves(state)``."""
    pods = [(n_pods_of(state),) + s for s in state.shapes]
    out = [()] + pods + pods
    if state.center is not None:
        out += list(state.shapes)
    if state.ef_error is not None:
        out += pods
    return out


def state_from_leaves(template: ElasticState, leaves: list) -> ElasticState:
    """The inverse of ``state_leaves`` into ``template``'s dtypes, device
    and layout; each leaf's shape is checked."""
    want = _leaf_shapes(template)
    if len(leaves) != len(want):
        raise ValueError(f"{len(leaves)} leaves for a state of {len(want)}")
    for i, (a, shape) in enumerate(zip(leaves, want)):
        if tuple(np.shape(a)) != tuple(shape):
            raise ValueError(f"leaf {i}: {np.shape(a)} vs {shape}")
    it = iter(leaves[1:])
    n_leaves = len(template.shapes)

    def glue(t, pods: bool):
        if t is None:
            return None
        parts = [_as_tensor(next(it), "cpu") for _ in range(n_leaves)]
        flat = (torch.cat([x.reshape(x.shape[0], -1) for x in parts], 1)
                if pods else torch.cat([x.reshape(-1) for x in parts]))
        return flat.to(device=t.device, dtype=t.dtype)

    return dataclasses.replace(
        template, step=int(np.asarray(leaves[0])),
        params=glue(template.params, True),
        momentum=glue(template.momentum, True),
        center=glue(template.center, False),
        ef_error=glue(template.ef_error, True))


# ---------------------------------------------------------------------------
# the update — one optimizer step given per-pod gradients (P, n)
# ---------------------------------------------------------------------------

def exchanges_at(state: ElasticState, cfg: ElasticConfig) -> bool:
    """True when this step runs the cross-pod exchange: Sync EASGD on a
    step that τ divides."""
    tau = cfg.easgd.tau
    return cfg.mode == "sync_easgd" and (tau <= 1 or state.step % tau == 0)


def _momentum_only(state: ElasticState, grads, cfg: ElasticConfig):
    """Between exchanges (step % τ ≠ 0) and for mode='msgd': eqs 3–4, in
    plain torch (the reference has no kernel for them), in place."""
    e = cfg.easgd
    state.momentum.copy_(e.mu * state.momentum.float()
                         - e.eta * grads.float())
    state.params.copy_(state.params.float() + state.momentum.float())
    return dataclasses.replace(state, step=state.step + 1)


def _n_total(state: ElasticState, plan) -> int:
    """The pod count of the whole run: the plan's on a pod group, else
    the state's rows."""
    if plan is not None and plan.group is not None:
        return plan.n_total
    return n_pods_of(state)


def _pod_mean(rows: torch.Tensor, plan) -> torch.Tensor:
    """The f32 mean over every pod of ``(P_local, n)`` rows: the local
    rows' mean on one device, their sum all-reduced over the plan's pod
    group on a mesh."""
    if plan is None or plan.group is None:
        return rows.float().mean(0)
    total = rows.float().sum(0)
    torch.distributed.all_reduce(total, group=plan.group)
    return total.div_(float(plan.n_total))


def _elastic_tensors(state, grads, cfg, mean_w, plan=None):
    """Per-tensor eqs 5–6 + eq 2 given the cross-pod mean of W_t, in plain
    torch (the reference's unpacked form: W' reads V' after its cast to
    the momentum dtype)."""
    e = cfg.easgd
    n_pods = _n_total(state, plan)
    w32, c32 = state.params.float(), state.center.float()
    v_new = (e.mu * state.momentum.float()
             - e.eta * grads.float()).to(state.momentum.dtype)
    w_new = w32 + v_new.float() - e.eta * e.rho * (w32 - c32)
    a = e.alpha * n_pods
    c_new = c32 + a * (mean_w.float() - c32)
    state.momentum.copy_(v_new)
    state.params.copy_(w_new)
    state.center.copy_(c_new)
    return dataclasses.replace(state, step=state.step + 1)


def _exchange_unpacked(state, grads, cfg, plan=None):
    """Per-tensor cross-pod mean (the paper's one-collective-per-layer
    baseline); on pod rows the per-tensor means are the row mean (on a
    pod group one all-reduce of it)."""
    mean_w = _pod_mean(state.params, plan)
    return _elastic_tensors(state, grads, cfg, mean_w, plan)


def _exchange_mean(state: ElasticState, plan: comm_plan.ExchangePlan):
    """The ONE cross-pod reduction (plan = schedule × compression):
    ``delta = W − C`` over the pod rows, its pod mean, ``mean_w = C +
    mean_delta``. Returns ``(mean_w, new error feedback)``."""
    c32 = state.center.float()
    delta = state.params.float() - c32
    mean_delta, ef_new = plan.reduce_mean_flat(delta, state.ef_error)
    del delta
    return mean_delta.add_(c32), ef_new


_SIDE_STREAMS: dict = {}


def start_exchange(state: ElasticState, cfg: ElasticConfig,
                   plan: comm_plan.ExchangePlan | None = None,
                   overlap: bool = False) -> PendingExchange:
    """Run the packed exchange of the start-of-step weights. With
    ``overlap`` on a CUDA device it runs on a second stream, after the work
    already queued on the current one; the update waits on its event."""
    if plan is None:
        plan = cfg.exchange_plan(n_pods_of(state), state.params.shape[1])
    if plan.group is not None:
        # the collective itself runs async (NCCL's own stream): W − C and
        # the local pod sum stay on the main stream
        c32 = state.center.float()
        finish = plan.start_reduce_mean_flat(state.params.float() - c32,
                                             state.ef_error)

        def done():
            mean_delta, ef_new = finish()
            return mean_delta.add_(c32), ef_new
        return PendingExchange(None, None, finish=done)
    dev = state.params.device
    if not (overlap and dev.type == "cuda"):
        return PendingExchange(*_exchange_mean(state, plan))
    main = torch.cuda.current_stream(dev)
    side = _SIDE_STREAMS.get(dev)
    if side is None:
        side = _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        mean_w, ef_new = _exchange_mean(state, plan)
        event = side.record_event()
    # allocated on the side stream, used on the main one
    mean_w.record_stream(main)
    if ef_new is not None:
        ef_new.record_stream(main)
    return PendingExchange(mean_w, ef_new, event)


def _exchange_packed(state, grads, cfg, pending: PendingExchange,
                     n_workers: int):
    """The fused elementwise update of W, V and W̄ (eqs 5–6 + 2) through
    the kernel, after the exchange."""
    e = cfg.easgd
    if pending.finish is not None:
        pending.mean_w, pending.ef_error = pending.finish()
    if pending.event is not None:
        torch.cuda.current_stream(state.params.device).wait_event(
            pending.event)
    eu.fused_elastic_update(state.params, state.momentum, grads, state.center,
                            pending.mean_w, eta=e.eta, rho=e.rho, mu=e.mu,
                            n_workers=n_workers)
    return dataclasses.replace(state, step=state.step + 1,
                               ef_error=pending.ef_error)


def apply_gradients(state: ElasticState, grads: torch.Tensor,
                    cfg: ElasticConfig, plan=None,
                    pending: PendingExchange | None = None) -> ElasticState:
    """One optimizer step, in place on the state's tensors; returns the
    state with ``step + 1``. ``grads`` is ``(P, n)`` like ``params``.
    ``plan`` overrides the exchange composition derived from ``cfg`` (the
    runtime builds it once); ``pending`` is an exchange already started
    for this step (``start_exchange``), else it runs here, after the
    gradients."""
    if cfg.mode == "msgd":
        # plain synchronous momentum SGD: grads are averaged over pods too,
        # so all pods stay identical (pure DP baseline)
        if _n_total(state, plan) > 1:
            grads = (_pod_mean(grads, plan)[None]
                     .expand_as(grads).to(grads.dtype))
        return _momentum_only(state, grads, cfg)
    if not exchanges_at(state, cfg):
        return _momentum_only(state, grads, cfg)
    if not cfg.packed:
        return _exchange_unpacked(state, grads, cfg, plan)
    if pending is None:
        pending = start_exchange(state, cfg, plan)
    return _exchange_packed(state, grads, cfg, pending,
                            _n_total(state, plan))
