"""Single-buffer ("packed layer") parameters — paper §5.2 (the port of
``repro/core/packing.py``).

Deep nets have hundreds of small tensors; one message per tensor pays the
latency α hundreds of times. Packing the whole parameter set into ONE
contiguous buffer pays it once and gives the fused update one flat pass.

``Packer`` turns a pytree (nested dicts and tuples) of tensors into a
single 1-D buffer and back, leaves in ``jax.tree_util`` order, padded to a
multiple of ``align``. The multi-pod step of this port keeps its state
packed all the time (``core.elastic``), so it never calls ``pack``; the
packer gives the layout (offsets, ``layer_sizes``, ``bucket_bounds``) that
the reference's packer gives on the same tree.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.comm.rounds import bucket_boundaries
from repro_torch.models.common import tree_leaves_with_path, tree_unflatten

# The reference's fused Pallas update tiles packed buffers in 8·128·128
# element blocks and its packer pads to the same multiple. Bucket cuts align
# on it, and parity with the reference needs the same cuts; the CUDA kernel
# itself takes any length and masks its tail.
ELASTIC_UPDATE_BLOCK = 8 * 128 * 128


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class _LeafSpec:
    shape: tuple
    dtype: Any
    offset: int  # element offset in the flat buffer
    size: int


class Packer:
    """Flattens a pytree of tensors into one contiguous 1-D buffer.

    Built once from a template pytree whose leaves have ``.shape`` and
    ``.dtype`` (tensors, or any stand-in). All leaves are stored in
    ``buffer_dtype`` (default f32): the packed buffer is the communication
    representation, so one dtype is both required and desirable.
    """

    def __init__(self, template, buffer_dtype=torch.float32,
                 align: int = ELASTIC_UPDATE_BLOCK):
        leaves = tree_leaves_with_path(template)
        self.structure = template
        self.buffer_dtype = buffer_dtype
        self.align = align
        specs, off = [], 0
        for _, leaf in leaves:
            size = math.prod(leaf.shape)
            specs.append(_LeafSpec(tuple(leaf.shape), leaf.dtype, off, size))
            off += size
        self.specs = tuple(specs)
        self.n_elements = off
        self.buffer_size = _round_up(max(off, 1), align)

    def pack(self, tree) -> torch.Tensor:
        """Pytree -> single 1-D buffer (``buffer_dtype``), padded."""
        leaves = [leaf for _, leaf in tree_leaves_with_path(tree)]
        if len(leaves) != len(self.specs):
            raise ValueError(f"packer built for {len(self.specs)} leaves, "
                             f"got {len(leaves)}")
        flat = [x.to(self.buffer_dtype).reshape(-1) for x in leaves]
        pad = self.buffer_size - self.n_elements
        if pad:
            flat.append(torch.zeros(pad, dtype=self.buffer_dtype,
                                    device=flat[0].device))
        return torch.cat(flat)

    def unpack(self, buffer: torch.Tensor):
        """Single 1-D buffer -> pytree with the template's shapes and
        dtypes."""
        leaves = [buffer[s.offset:s.offset + s.size].reshape(s.shape)
                  .to(s.dtype) for s in self.specs]
        return tree_unflatten(self.structure, leaves)

    def layer_sizes(self) -> list:
        """Per-leaf element counts in packed order."""
        return [s.size for s in self.specs]

    def bucket_bounds(self, target_elems: int) -> list:
        """Bucket cut offsets over the padded buffer: leaf edges grouped to
        about ``target_elems`` elements and rounded up to ``align``, the
        policy of the reference's packer."""
        return bucket_boundaries(self.layer_sizes(), self.buffer_size,
                                 target_elems, align=self.align)


def packed_apply(packer: Packer, fn, tree):
    """Apply ``fn`` to the packed representation and unpack the result."""
    return packer.unpack(fn(packer.pack(tree)))
