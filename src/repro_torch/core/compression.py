"""Compression of the cross-pod exchange (the port of
``repro/core/compression.py``).

 * ``bf16``    — cast the packed delta to bfloat16 (2× fewer bytes), with
   error feedback carrying the rounding to the next exchange.
 * ``sign_ef`` — 1-bit sign compression with error feedback: signs travel
   as int8 (±1) so the reduction over pods can add them (exact for ≤ 127
   pods), and each pod's scale (the mean |value|) travels beside them.

``encode(buf, err) -> (payload, new_err)`` works on ONE pod's 1-D row; the
exchange (``comm.plan.ExchangePlan.reduce_mean_flat``) applies it to each
pod row, as the reference's ``jax.vmap(encode)`` does, sums every payload
leaf over the pod rows and divides by the pod count before
``decode_mean``.

Two byte accountings, as in the reference: ``jit_wire_bytes_per_element``
is what the reduction over pod rows moves (sign_ef: one int8 per element);
``wire_bytes_per_element`` is the framed wire's (sign_ef: bit-packed, the
numpy codecs below, copied from the reference).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Compression:
    """A compression scheme for a mean over pods of a flat buffer."""

    name: str
    encode: Callable
    decode_mean: Callable
    wire_bytes_per_element: float       # framed wire (bit-packed signs)
    jit_wire_bytes_per_element: float = 0.0   # the reduction over pod
    #                                     rows (signs stay int8 so the sum
    #                                     can address them)

    def __post_init__(self):
        if self.jit_wire_bytes_per_element == 0.0:
            object.__setattr__(self, "jit_wire_bytes_per_element",
                               self.wire_bytes_per_element)


def _identity_encode(buf, err):
    return (buf,), err


def _identity_decode(payload):
    return payload[0]


NONE = Compression("none", _identity_encode, _identity_decode, 4.0)


def _bf16_encode(buf, err):
    corrected = buf + err
    q = corrected.to(torch.bfloat16)
    new_err = corrected - q.to(buf.dtype)
    return (q,), new_err


def _bf16_decode(payload):
    return payload[0].to(torch.float32)


BF16 = Compression("bf16", _bf16_encode, _bf16_decode, 2.0)


def _sign_encode(buf, err):
    corrected = buf + err
    scale = torch.mean(torch.abs(corrected))
    signs = torch.where(corrected >= 0, 1, -1).to(torch.int8)
    decompressed = signs.to(buf.dtype) * scale
    new_err = corrected - decompressed
    return (signs, scale), new_err


def _sign_decode(payload):
    # the mean over pods of ±1 times the mean per-pod magnitude approximates
    # the mean of sign_i·scale_i; error feedback absorbs the difference
    signs_mean, scale_mean = payload
    return signs_mean.to(torch.float32) * scale_mean.to(torch.float32)


SIGN_EF = Compression("sign_ef", _sign_encode, _sign_decode,
                      0.125 + 1e-9, 1.0 + 1e-9)


SCHEMES = {c.name: c for c in (NONE, BF16, SIGN_EF)}


def get(name: str) -> Compression:
    try:
        return SCHEMES[name]
    except KeyError:
        raise ValueError(
            f"unknown compression '{name}', have {sorted(SCHEMES)}"
        ) from None


# ---------------------------------------------------------------------------
# numpy wire codecs — the same sign-EF math as a byte stream for a framed
# point-to-point wire, where no reduction happens in flight and the signs
# are bit-packed for real (copied from the reference)
# ---------------------------------------------------------------------------

def sign_ef_encode_np(buf: np.ndarray, err: np.ndarray
                      ) -> tuple[bytes, np.ndarray]:
    """(flat float64 buf, EF state) -> (wire payload, new EF state).

    Payload layout: [u64 n][f64 scale][packbits(signs)].
    """
    corrected = buf + err
    scale = float(np.mean(np.abs(corrected))) if buf.size else 0.0
    bits = (corrected >= 0)
    decompressed = np.where(bits, scale, -scale)
    new_err = corrected - decompressed
    header = np.array([buf.size], np.uint64).tobytes() + \
        np.array([scale], np.float64).tobytes()
    return header + np.packbits(bits).tobytes(), new_err


def sign_ef_decode_np(payload) -> np.ndarray:
    """Inverse of ``sign_ef_encode_np`` (stateless)."""
    mv = memoryview(payload)
    n = int(np.frombuffer(mv[:8], np.uint64)[0])
    scale = float(np.frombuffer(mv[8:16], np.float64)[0])
    bits = np.unpackbits(np.frombuffer(mv[16:], np.uint8), count=n)
    return np.where(bits.astype(bool), scale, -scale)


def sign_ef_wire_nbytes(n: int) -> int:
    """Exact framed payload size for an n-element sign_ef message."""
    return 16 + (n + 7) // 8
