"""Hand-written CUDA kernels for Hopper and their plain torch versions.

Kernels are built and loaded on first use (``kernels._build``), never at
import: the CPU tests import every module on a machine without ``nvcc``.
``reset_launch_counts`` / ``launch_counts`` cover every wrapper below;
``add_launch_counts`` folds in the counts of other processes.
"""
from repro_torch.kernels import _build
from repro_torch.kernels.elastic_update import (fused_elastic_update,
                                                fused_sync_easgd_update,
                                                fused_sync_sgd_update)
from repro_torch.kernels.flash_attention import (flash_attention_bwd,
                                                 flash_attention_fwd)
from repro_torch.kernels.fused_ce import fused_ce_bwd, fused_ce_fwd
from repro_torch.kernels.ssd_chunk import ssd_intra_bwd, ssd_intra_fwd

KERNELS = (fused_sync_easgd_update, fused_sync_sgd_update,
           flash_attention_fwd, flash_attention_bwd, fused_ce_fwd,
           fused_ce_bwd, fused_elastic_update, ssd_intra_fwd, ssd_intra_bwd)

__all__ = ["KERNELS", "add_launch_counts", "flash_attention_bwd",
           "flash_attention_fwd", "fused_ce_bwd", "fused_ce_fwd",
           "fused_elastic_update", "fused_sync_easgd_update",
           "fused_sync_sgd_update", "launch_counts", "reset_launch_counts",
           "ssd_intra_bwd", "ssd_intra_fwd"]


def reset_launch_counts() -> None:
    _build.reset_counts(KERNELS)


def add_launch_counts(launched: dict) -> None:
    _build.add_counts(KERNELS, launched)


def launch_counts() -> dict:
    return _build.counts(KERNELS)
