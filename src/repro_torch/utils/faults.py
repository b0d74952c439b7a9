"""Planted faults: one collective of the layer kinds on a mesh broken in
this process, so that a holder of the meshed step against the un-meshed
one can show that its limit catches what it must (``chip_smoke.py``'s
phase 25 and ``tests/test_torch_mesh_kinds*.py`` and
``tests/test_torch_mesh_serve.py`` plant them).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models import moe, tp


def plant(fault):
    """Break one collective of ``models.tp`` / ``models.moe`` in this
    process (``None`` breaks nothing); returns a function that restores
    it.

    * ``all_to_all``: the dispatch skipped, each rank keeping its own
      buffer's blocks;
    * ``local_aux``: each rank's aux loss its own tokens' over ``data``
      (the mean of the ranks' local aux losses);
    * ``copy_in``: a replicated input's gradient left unsummed over
      ``model``;
    * ``norm_sum``: the gated norm's variance summed over ``model`` in
      the forward only (every rank's loss right, its gradient wrong);
    * ``norm_local``: the gated norm's variance without its sum (each
      rank's channels alone);
    * ``gate_identity``: the RG-LRU gate partials all-reduced with the
      identity backward;
    * ``combine_no_rescale``: flash-decoding's combine without the max
      rescale (each rank's terms summed as they are, against their own
      running max);
    * ``combine_drop``: flash-decoding's combine with the last block's
      partial left out."""
    saved = []

    def patch(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    if fault == "all_to_all":
        patch(dist, "all_to_all_single",
              lambda out, inp, group=None: out.copy_(inp))
    elif fault == "local_aux":
        real = moe.route

        def local(cfg, router, x, G=None, C=None, aux_share=None):
            lay = tp.current()
            k = cfg.moe.top_k

            def share(probs, counts):
                n = probs.shape[0] * probs.shape[1]
                return (probs.mean(dim=(0, 1)) / lay.data_size,
                        counts * (1.0 / (n * k)))
            return real(cfg, router, x, G, C, aux_share=share)
        patch(moe, "route", local)
    elif fault == "copy_in":
        patch(tp._CopyIn, "backward",
              staticmethod(lambda ctx, g: (g, None)))
    elif fault == "norm_sum":
        patch(tp._ModelSum, "backward",
              staticmethod(lambda ctx, g: (g, None)))
    elif fault == "norm_local":
        patch(tp, "model_sum", lambda x, layout=None: x)
    elif fault == "gate_identity":
        def identity(x, dim, group):
            lay = tp.current()
            block = x.shape[dim] // lay.model_size
            return tp.reduce_out(x).narrow(dim, lay.model_rank * block,
                                           block)
        patch(tp, "reduce_scatter", identity)
    elif fault == "combine_no_rescale":
        patch(tp, "_combine_weight", lambda m, M, split: torch.ones_like(m))
    elif fault == "combine_drop":
        def drop(m, M, split):
            last = split.index == split.length // split.block - 1
            return torch.exp(m - M) * (0.0 if last else 1.0)
        patch(tp, "_combine_weight", drop)
    elif fault is not None:
        raise ValueError(fault)

    def restore():
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
    return restore
