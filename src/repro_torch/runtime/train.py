"""The training step: the model's forward and backward per pod, then the
Sync EASGD exchange and update (the port of ``repro/runtime/train.py``).

The step is the paper's Algorithm 4 on P pods:
  1. the packed cross-pod exchange of the start-of-step weights starts
     first (``core.elastic.start_exchange``; on a second CUDA stream with
     ``overlap``, or on a mesh as an async collective over the ``pod``
     group, so it runs under the gradients — Sync EASGD3);
  2. each pod computes its gradient on its own batch: ``lm_loss`` forward
     and backward through the attention and cross-entropy kernels, on a
     leaf whose views are the pod's parameters, so the gradient comes back
     as one flat row and lands in row i of a ``(P, n)`` f32 ``G`` (the
     reference's ``jax.vmap`` over pods becomes a loop over the local pods);
  3. the fused elementwise EASGD update (eqs. 5–6 + 2) in place on the
     state, through ``fused_elastic_update``.

On a ``(pod, data, model)`` mesh of processes (``launch.mesh``) each rank
holds its pods' rows of its shards (``runtime.sharding.param_specs``:
TP over ``model``, selective FSDP over ``data``, the MoE experts over
``data``) and runs the same step on
them: its rows of each pod's batch (``batch_specs``: the batch over
``data``; with microbatches, its rows of each microbatch), the model on
local shards with explicit collectives (``models.tp``, the FSDP gathers of
``block_constrainer``, the vocab-parallel loss head), the gradient's
intra-pod sum over ``data`` (an ``all_reduce`` of the leaves ``data``
does not split — Partial to Replicate — and the gathers' reduce-scatter
for those it does), then the exchange over the ``pod`` group. On a mesh
whose ``data`` and ``model`` sizes are 1 nothing is split and the step is
the un-meshed one op for op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.distributed as dist

from repro_torch.core import elastic
from repro_torch.core.elastic import ElasticConfig, ElasticState
from repro_torch.models import tp
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (ModelConfig, init_params, spec_leaves,
                                       tree_leaves_with_path, tree_unflatten)
from repro_torch.runtime import sharding as shd
from repro_torch.utils import opcount_hook
from repro_torch.utils.device import fp32_products, resolve_device

METRICS = ("ce", "aux", "accuracy", "tokens")


@dataclasses.dataclass(frozen=True)
class TrainBuild:
    """What the launcher needs for one training setup."""
    step: Any                  # (state, batch) -> (state, metrics)
    init_state: Any            # () -> ElasticState (allocates!)
    n_pods: int
    exchange_plan: Any = None  # comm.plan.ExchangePlan the step executes
    state_specs: Any = None    # elastic.StateSpecs (None without a mesh)
    batch_spec_tree: Any = None
    param_specs: Any = None
    mesh: Any = None


def make_batch_defs(cfg: ModelConfig, n_pods: int, per_pod_batch: int,
                    seq: int) -> dict:
    """The training batch's ``{name: (shape, dtype)}`` with the leading
    ``(n_pods, B_local, S)`` layout."""
    B, S = per_pod_batch, seq
    batch = {"tokens": ((n_pods, B, S), torch.int32),
             "targets": ((n_pods, B, S), torch.int32),
             "mask": ((n_pods, B, S), torch.float32)}
    if cfg.mrope_sections is not None:
        batch["mrope_positions"] = ((n_pods, 3, B, S), torch.int32)
    if cfg.patch_embed_tokens:
        batch["patch_embeds"] = ((n_pods, B, cfg.patch_embed_tokens,
                                  cfg.d_model), cfg.compute_dtype)
    return batch


@dataclasses.dataclass(frozen=True)
class _Placement:
    """A rank's part of the step on a mesh (None fields: no mesh)."""
    layout: Any = None            # models.tp.Layout
    constrain: Any = None         # the FSDP block gather
    row_layout: Any = None        # [(path, local shape)]
    data_group: Any = None        # the gradient's intra-pod sum
    data_spans: tuple = ()        # row spans data does not split


def _pod_gradient(cfg: ModelConfig, row: torch.Tensor, batch: dict,
                  pl: _Placement = _Placement()):
    """``lm_loss`` and its gradient for one pod: the parameters are views
    of one leaf that shares ``row``'s storage, so the gradient is the flat
    row in ravel order. On a mesh the gradient is this rank's shard,
    summed over ``data``, and the loss and metrics are the pod's."""
    leaf = row.detach().requires_grad_(True)
    params = tfm.unflatten(leaf, cfg, pl.row_layout)
    extra = {"constrain": pl.constrain} if pl.constrain else None
    with tp.use(pl.layout):
        loss, metrics = tfm.lm_loss(cfg, params, batch, extra)
        (grad,) = torch.autograd.grad(loss, leaf)
    loss = loss.detach()
    metrics = {k: metrics[k].detach() for k in METRICS}
    if pl.data_group is not None:
        _sum_spans(grad, pl.data_spans, pl.data_group)
        v = tp.data_sum(torch.stack([loss, metrics["ce"], metrics["aux"],
                                     metrics["accuracy"]]), pl.layout)
        loss, metrics["ce"], metrics["aux"], metrics["accuracy"] = v.unbind()
    return loss, metrics, grad


def _sum_spans(row: torch.Tensor, spans: tuple, group) -> None:
    """All-reduce the ``[a, b)`` spans of ``row`` over ``group`` in place,
    as one collective."""
    if len(spans) == 1 and spans[0] == (0, row.numel()):
        opcount_hook.collective("all-reduce", row, group)
        dist.all_reduce(row, group=group)
        return
    buf = torch.cat([row[a:b] for a, b in spans])
    opcount_hook.collective("all-reduce", buf, group)
    dist.all_reduce(buf, group=group)
    off = 0
    for a, b in spans:
        row[a:b].copy_(buf[off:off + b - a])
        off += b - a


def _data_spans(row_layout: list, specs: list) -> tuple:
    """The row spans of the leaves whose spec leaves ``data`` unsplit,
    adjacent ones merged."""
    spans, off = [], 0
    for (_, shape), spec in zip(row_layout, specs):
        size = math.prod(shape)
        if "data" not in shd.spec_axes(spec) and size:
            if spans and spans[-1][1] == off:
                spans[-1] = (spans[-1][0], off + size)
            else:
                spans.append((off, off + size))
        off += size
    return tuple(spans)


def _placement(cfg: ModelConfig, mesh, pspecs) -> _Placement:
    sizes = shd.mesh_axis_sizes(mesh)
    row_layout = shd.local_layout(cfg, mesh)
    layout = tp.layout_for(cfg, mesh)
    if layout is None:
        return _Placement(row_layout=row_layout)
    dsz = sizes.get("data", 1)
    return _Placement(
        layout=layout, constrain=shd.block_constrainer(cfg, mesh),
        row_layout=row_layout,
        data_group=mesh.get_group("data") if dsz > 1 else None,
        data_spans=_data_spans(row_layout, spec_leaves(pspecs)))


def build_train_step(cfg: ModelConfig, ecfg: ElasticConfig, *, n_pods: int,
                     per_pod_batch: int, seq: int, seed: int = 0,
                     microbatches: int = 1, device=None,
                     mesh=None) -> TrainBuild:
    """``microbatches`` > 1 accumulates each pod's gradient over batch
    slices, in the reference's order (``a + g / m``): activation memory
    scales with the microbatch while the exchange and the update still see
    the full batch.

    ``step(state, batch)`` takes a batch of ``(n_pods, B, S)`` arrays
    (numpy or tensors) and returns the new state and the metrics averaged
    over pods, as 0-d tensors on the device (reading them synchronises).
    The state's tensors are updated in place.

    ``mesh`` (``launch.mesh``; None: one device) places the step: every
    rank passes the same whole batch and takes its part; ``n_pods`` is a
    multiple of the ``pod`` axis's size. Every layer kind runs on a mesh
    (``models.tp``)."""
    dev = resolve_device(device)
    fp32_products()
    if per_pod_batch % microbatches:
        raise ValueError(f"per_pod_batch {per_pod_batch} is not a multiple "
                         f"of microbatches {microbatches}")
    n = tfm.n_params(cfg)
    m, mb = microbatches, per_pod_batch // microbatches
    pl, group, specs = _Placement(), None, {}
    pods, pod0, rows, row0 = n_pods, 0, mb, 0
    if mesh is not None:
        sizes = shd.mesh_axis_sizes(mesh)
        psz, dsz = sizes.get("pod", 1), sizes.get("data", 1)
        if n_pods % psz:
            raise ValueError(f"n_pods {n_pods} is not a multiple of the "
                             f"pod axis's {psz}")
        if mb % dsz:
            raise ValueError(f"a microbatch of {mb} rows does not split "
                             f"over data {dsz}")
        pods, rows = n_pods // psz, mb // dsz
        if psz > 1:
            group = mesh.get_group("pod")
            pod0 = mesh.get_local_rank("pod") * pods
        row0 = mesh.get_local_rank("data") * rows if dsz > 1 else 0
        pspecs = shd.param_specs(cfg, mesh)
        pod_axis = "pod" if "pod" in sizes else None
        specs = dict(param_specs=pspecs,
                     state_specs=elastic.state_specs(pspecs, ecfg, pod_axis),
                     batch_spec_tree=shd.batch_specs(cfg, mesh,
                                                     pod_dim=True))
        pl = _placement(cfg, mesh, pspecs)
    # the ONE cross-pod exchange, built once and executed by every step;
    # "auto" resolves here from the packed bytes and the pod count
    exchange_plan = ecfg.exchange_plan(n_total=n_pods, n_elements=n,
                                       group=group)
    m_div = torch.full((), float(m), dtype=torch.float32, device=dev)

    def local_batch(batch: dict, k: int) -> dict:
        """Microbatch k's rows of this rank's pods (of every pod without
        a mesh): ``(pods, rows, ...)``; mrope_positions carries the batch
        at dim 2."""
        lo = k * mb + row0
        out = {}
        for key, v in batch.items():
            v = torch.as_tensor(v)[pod0:pod0 + pods]
            v = v[:, :, lo:lo + rows] if key == "mrope_positions" \
                else v[:, lo:lo + rows]
            out[key] = v.to(dev)
        out["tokens"] = out["tokens"].long()
        return out

    def step(state: ElasticState, batch: dict):
        parts = [local_batch(batch, k) for k in range(m)]
        pending = None
        if ecfg.packed and ecfg.overlap and elastic.exchanges_at(state,
                                                                  ecfg):
            pending = elastic.start_exchange(state, ecfg, exchange_plan,
                                             overlap=True)
        n_row = state.params.shape[1]
        # one pod without microbatches: G is the gradient row itself
        grads = None if pods == 1 and m == 1 else torch.empty(
            (pods, n_row), dtype=torch.float32, device=dev)
        losses, metrics = [], {k: [] for k in METRICS}
        for i in range(pods):
            if grads is None:
                pod = {k: v[i] for k, v in parts[0].items()}
                loss, mets, g = _pod_gradient(cfg, state.params[i], pod, pl)
                grads = g[None]
                del g
            elif m == 1:
                pod = {k: v[i] for k, v in parts[0].items()}
                loss, mets, g = _pod_gradient(cfg, state.params[i], pod, pl)
                grads[i].copy_(g)
                del g
            else:
                grads[i].zero_()
                loss = torch.zeros((), device=dev)
                mets = {k: torch.zeros((), device=dev) for k in METRICS}
                for part in parts:
                    pod = {k: v[i] for k, v in part.items()}
                    l_k, m_k, g = _pod_gradient(cfg, state.params[i], pod,
                                                pl)
                    grads[i].add_(g / m_div)
                    del g
                    loss = loss + l_k / m_div
                    mets = {key: mets[key] + m_k[key] / m_div
                            for key in METRICS}
            losses.append(loss)
            for key in METRICS:
                metrics[key].append(mets[key])
        new_state = elastic.apply_gradients(state, grads, ecfg,
                                            plan=exchange_plan,
                                            pending=pending)
        if group is None:
            out = {"loss": torch.stack(losses).mean(),
                   **{k: torch.stack(v).mean() for k, v in metrics.items()}}
            return new_state, out
        # the mean over every pod: the local pods' sums, summed over pods
        keys = ("loss",) + METRICS
        sums = torch.stack([torch.stack(losses).sum()] + [
            torch.stack(metrics[k]).sum() for k in METRICS])
        opcount_hook.collective("all-reduce", sums, group)
        dist.all_reduce(sums, group=group)
        return new_state, dict(zip(keys, (sums / n_pods).unbind()))

    def init_state() -> ElasticState:
        # drawn on the run's device: parity runs carry a state across
        # (``elastic.state_from_jax``, ``ElasticState.to``) instead. On a
        # mesh every rank draws the whole params and keeps its shard.
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(tfm.model_defs(cfg), gen, cfg.param_dtype,
                             device=dev)
        if mesh is not None:
            params = tree_unflatten(params, [
                shd.local_shard(t, mesh, spec) for (_, t), spec in
                zip(tree_leaves_with_path(params),
                    spec_leaves(specs["param_specs"]))])
        return elastic.init(params, ecfg, pods)

    return TrainBuild(step=step, init_state=init_state, n_pods=n_pods,
                      exchange_plan=exchange_plan, mesh=mesh, **specs)
