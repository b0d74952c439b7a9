"""The training step: the model's forward and backward per pod, then the
Sync EASGD exchange and update (the port of ``repro/runtime/train.py``).

The step is the paper's Algorithm 4 on P pods of one device:
  1. the packed cross-pod exchange of the start-of-step weights starts
     first (``core.elastic.start_exchange``; on a second CUDA stream with
     ``overlap``, so it runs under the gradients — Sync EASGD3);
  2. each pod computes its gradient on its own batch: ``lm_loss`` forward
     and backward through the attention and cross-entropy kernels, on a
     leaf whose views are the pod's parameters, so the gradient comes back
     as one flat row and lands in row i of a ``(P, n)`` f32 ``G`` (the
     reference's ``jax.vmap`` over pods becomes a loop);
  3. the fused elementwise EASGD update (eqs. 5–6 + 2) in place on the
     state, through ``fused_elastic_update``.

What has no counterpart on one device: ``runtime/sharding.py`` (the
PartitionSpecs, the batch and activation constrainers) and the mesh of
``launch/mesh.py``. So ``TrainBuild`` keeps ``step``, ``init_state``,
``n_pods`` and ``exchange_plan`` and drops the reference's spec fields;
the multi-GPU work in ROADMAP.md will need them again.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import elastic
from repro_torch.core.elastic import ElasticConfig, ElasticState
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ModelConfig, init_params
from repro_torch.utils.device import fp32_products, resolve_device

METRICS = ("ce", "aux", "accuracy", "tokens")


@dataclasses.dataclass(frozen=True)
class TrainBuild:
    """What the launcher needs for one training setup."""
    step: Any                  # (state, batch) -> (state, metrics)
    init_state: Any            # () -> ElasticState (allocates!)
    n_pods: int
    exchange_plan: Any = None  # comm.plan.ExchangePlan the step executes


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


def _pod_gradient(cfg: ModelConfig, row: torch.Tensor, batch: dict):
    """``lm_loss`` and its gradient for one pod: the parameters are views
    of one leaf that shares ``row``'s storage, so the gradient is the flat
    row in ravel order."""
    leaf = row.detach().requires_grad_(True)
    loss, metrics = tfm.lm_loss(cfg, tfm.unflatten(leaf, cfg), batch)
    (grad,) = torch.autograd.grad(loss, leaf)
    return loss.detach(), {k: metrics[k].detach() for k in METRICS}, grad


def build_train_step(cfg: ModelConfig, ecfg: ElasticConfig, *, n_pods: int,
                     per_pod_batch: int, seq: int, seed: int = 0,
                     microbatches: int = 1, device=None) -> TrainBuild:
    """``microbatches`` > 1 accumulates each pod's gradient over batch
    slices, in the reference's order (``a + g / m``): activation memory
    scales with the microbatch while the exchange and the update still see
    the full batch.

    ``step(state, batch)`` takes a batch of ``(n_pods, B, S)`` arrays
    (numpy or tensors) and returns the new state and the metrics averaged
    over pods, as 0-d tensors on the device (reading them synchronises).
    The state's tensors are updated in place."""
    dev = resolve_device(device)
    fp32_products()
    if per_pod_batch % microbatches:
        raise ValueError(f"per_pod_batch {per_pod_batch} is not a multiple "
                         f"of microbatches {microbatches}")
    n = tfm.n_params(cfg)
    # the ONE cross-pod exchange, built once and executed by every step;
    # "auto" resolves here from the packed bytes and the pod count
    exchange_plan = ecfg.exchange_plan(n_total=n_pods, n_elements=n)
    m, mb = microbatches, per_pod_batch // microbatches
    m_div = torch.full((), float(m), dtype=torch.float32, device=dev)

    def step(state: ElasticState, batch: dict):
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        batch["tokens"] = batch["tokens"].long()
        pending = None
        if ecfg.packed and ecfg.overlap and elastic.exchanges_at(state,
                                                                  ecfg):
            pending = elastic.start_exchange(state, ecfg, exchange_plan,
                                             overlap=True)
        grads = torch.empty((n_pods, n), dtype=torch.float32, device=dev)
        losses, metrics = [], {k: [] for k in METRICS}
        for i in range(n_pods):
            pod = {k: v[i] for k, v in batch.items()}
            if m == 1:
                loss, mets, g = _pod_gradient(cfg, state.params[i], pod)
                grads[i].copy_(g)
                del g
            else:
                grads[i].zero_()
                loss = torch.zeros((), device=dev)
                mets = {k: torch.zeros((), device=dev) for k in METRICS}
                for k in range(m):
                    # mrope_positions carries the batch at dim 1: (3, B, S)
                    part = {key: (v[:, k * mb:(k + 1) * mb]
                                  if key == "mrope_positions"
                                  else v[k * mb:(k + 1) * mb])
                            for key, v in pod.items()}
                    l_k, m_k, g = _pod_gradient(cfg, state.params[i], part)
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
        out = {"loss": torch.stack(losses).mean(),
               **{k: torch.stack(v).mean() for k, v in metrics.items()}}
        return new_state, out

    def init_state() -> ElasticState:
        # drawn on the run's device: parity runs carry a state across
        # (``elastic.state_from_jax``, ``ElasticState.to``) instead
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = init_params(tfm.model_defs(cfg), gen, cfg.param_dtype,
                             device=dev)
        return elastic.init(params, ecfg, n_pods)

    return TrainBuild(step=step, init_state=init_state, n_pods=n_pods,
                      exchange_plan=exchange_plan)
