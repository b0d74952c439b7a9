"""The port's wire format is the reference's, byte for byte.

For every frame type and both payload codecs, the bytes the port's
``repro_torch.net.wire.Link`` puts on a socket equal the reference's
(``repro.net.wire``, jax-free), and a frame sent by either side decodes
with the other's module, over a socket pair. Sign-EF frames are sent
twice, so the error-feedback state must also evolve identically.
"""
import json
import socket

import numpy as np
import pytest

from repro.net import wire as ref_wire
from repro_torch.net import wire

FRAMES = sorted(ref_wire.FRAME_NAMES)
ARRAY_FRAMES = {ref_wire.WEIGHTS, ref_wire.GRAD, ref_wire.WSTATE,
                ref_wire.SEGMENT, ref_wire.CENTER}
SIMPLE_FRAMES = {ref_wire.READY, ref_wire.DONE}


def test_constants_and_frame_names_match():
    assert wire.FRAME_NAMES == ref_wire.FRAME_NAMES
    assert wire.CODECS == ref_wire.CODECS
    assert (wire.MAGIC, wire.VERSION, wire.HEADER_SIZE) == (
        ref_wire.MAGIC, ref_wire.VERSION, ref_wire.HEADER_SIZE)
    for name in wire.FRAME_NAMES.values():
        assert getattr(wire, name) == getattr(ref_wire, name)


def _payload(ftype):
    if ftype in ARRAY_FRAMES:
        rng = np.random.RandomState(ftype)
        return rng.randn(2 * 37)                 # two segments of 37
    return {"wid": 3, "token": "t", "t": 1.25, "kind": int(ftype)}


def _send(mod, link, ftype, codec):
    """One frame of ``ftype`` through ``mod``'s Link (twice for arrays:
    the second sign-EF frame carries the first's residual)."""
    pay = _payload(ftype)
    if ftype in ARRAY_FRAMES:
        for _ in range(2):
            link.send_array(ftype, pay, wid=5, segments=2, ef_tag=(1, "add"))
    elif ftype in SIMPLE_FRAMES:
        link.send_simple(ftype, wid=5)
    else:
        link.send_json(ftype, pay, wid=5)


def _emit(mod, ftype, codec) -> bytes:
    a, b = socket.socketpair()
    _send(mod, mod.Link(a, codec=codec), ftype, codec)
    a.close()
    out = b""
    while chunk := b.recv(1 << 16):
        out += chunk
    b.close()
    return out


@pytest.mark.parametrize("codec", ["none", "sign_ef"])
@pytest.mark.parametrize("ftype", FRAMES)
def test_port_frames_are_the_reference_bytes(ftype, codec):
    got = _emit(wire, ftype, codec)
    assert len(got) >= wire.HEADER_SIZE
    assert got == _emit(ref_wire, ftype, codec)


def _recv(mod, link, ftype):
    frame = link.recv_header(skip_heartbeat=False)
    assert (frame.ftype, frame.wid) == (ftype, 5)
    if ftype in ARRAY_FRAMES:
        first = link.recv_array(frame)
        second = link.recv_array(link.recv_header())
        return [np.asarray(first), np.asarray(second)]
    if ftype in SIMPLE_FRAMES:
        link.recv_discard(frame)
        return None
    return link.recv_json(frame)


@pytest.mark.parametrize("codec", ["none", "sign_ef"])
@pytest.mark.parametrize("ftype", FRAMES)
@pytest.mark.parametrize("direction", ["port_to_ref", "ref_to_port"])
def test_frames_decode_with_the_other_module(direction, ftype, codec):
    src, dst = ((wire, ref_wire) if direction == "port_to_ref"
                else (ref_wire, wire))
    a, b = socket.socketpair()
    tx, rx = src.Link(a, codec=codec), dst.Link(b)
    _send(src, tx, ftype, codec)
    got = _recv(dst, rx, ftype)
    # the sending module decodes its own frames the same way
    c, d = socket.socketpair()
    _send(src, src.Link(c, codec=codec), ftype, codec)
    want = _recv(src, src.Link(d), ftype)
    if ftype in ARRAY_FRAMES:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        if codec == "none":
            np.testing.assert_array_equal(got[0], _payload(ftype))
    else:
        assert got == want
        if got is not None:
            assert json.loads(json.dumps(got)) == _payload(ftype)
    for s in (a, b, c, d):
        s.close()


def test_parse_header_reads_the_reference_headers():
    """``parse_header`` (the p2p engine's own header path) reads the
    reference's headers."""
    a, b = socket.socketpair()
    ref_wire.Link(a).send_array(ref_wire.SEGMENT, np.ones(3), wid=0x7FFF)
    hdr = b.recv(wire.HEADER_SIZE)
    frame = wire.parse_header(hdr)
    assert (frame.ftype, frame.wid, frame.size) == (wire.SEGMENT, 0x7FFF, 24)
    a.close(), b.close()
