"""The hook through which the port reports work that its aten ops alone
do not show to an op count (``launch.opcount.OpCounter``):

* ``kernel_region(work, outputs)`` marks each call of a hand-written kernel's
  wrapper as one region: the counter adds ``work(*args, **kwargs)``, the
  kernel's ``(bytes, operations)`` from ``core.costmodel``, once, and
  none of the ops inside (the plain version's, where it runs);
* ``collective(kind, tensor, group, tag)``, called where the port makes
  a ``torch.distributed`` collective, adds its bytes by kind and dtype
  (and by ``tag``, where one is given).

With no counter active each hook is one read of a module global: nothing
on the step's path changes. The counter in force is a global, not a
context variable, because a backward runs in the autograd engine's
thread, where the forward's context is unset.
"""
from __future__ import annotations

import functools

_active = None


def active():
    """The counter in force, or None."""
    return _active


def set_active(counter):
    """Put ``counter`` (or None) in force; returns the one it replaces."""
    global _active
    prev, _active = _active, counter
    return prev


def kernel_region(work, outputs=None):
    """Decorate a kernel's wrapper so that, under a counter, each call is
    one region named after the wrapper whose work is ``work(*args,
    **kwargs)``. ``outputs(*args, **kwargs)`` makes what the kernel
    returns, uninitialised (None: an in-place kernel, which returns
    nothing): a counter made with ``stand_ins=True`` calls it instead of
    the wrapper, so a traced step on fake tensors, which have no values
    for a plain version to branch on, holds what the card holds (module
    docstring of ``launch.opcount``)."""
    def wrap(fn):
        @functools.wraps(fn)
        def counted(*args, **kwargs):
            counter = _active
            if counter is None:
                return fn(*args, **kwargs)
            with counter.region(fn.__name__, work(*args, **kwargs)):
                if counter.stand_ins:
                    return outputs and outputs(*args, **kwargs)
                return fn(*args, **kwargs)
        return counted
    return wrap


def collective(kind: str, tensor, group=None, tag=None) -> None:
    """Report one collective of ``kind`` (the reference's HLO names:
    ``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute``) whose result, or sent buffer, is ``tensor``,
    over ``group`` (None: the world); ``tag`` names the part of the
    step it belongs to, which the counter also sums apart."""
    counter = _active
    if counter is not None:
        counter.collective(kind, tensor, group, tag)
