"""Activation-sharding context (the port of ``repro/models/sctx.py``).

Model code is mesh-agnostic: the runtime installs a constraint function
here and blocks call ``shard(x, *logical_axes)`` at the reference's
layout-critical points (projection outputs, block boundaries, the FFN
hidden, the embedding). Without an installed function, and on one device,
``shard`` returns ``x``. The port's runtimes install none, on a mesh
too: the model runs on local shards, whose layout the explicit
collectives of ``models.tp`` make at these same points.
``runtime.sharding.activation_constrainer`` maps the logical axes to the
reference's ``PartitionSpec``.

Logical activation axes: "batch", "seq", "embed", "heads", "kv_heads",
"head_dim", "ff", "vocab", "experts", "groups", "inner".
"""
from __future__ import annotations

import contextlib
import contextvars

_ctx = contextvars.ContextVar("activation_sharding", default=None)


def shard(x, *logical):
    """Apply the installed constraint (no-op when none installed)."""
    fn = _ctx.get()
    if fn is None:
        return x
    return fn(x, logical)


@contextlib.contextmanager
def use(fn):
    token = _ctx.set(fn)
    try:
        yield
    finally:
        _ctx.reset(token)
