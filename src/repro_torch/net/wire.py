"""The wire of the tcp transport: a length-prefixed binary protocol (the
port of ``repro/net/wire.py``; the frame format is the reference's byte for
byte, so either side's frames decode with the other's module).

One frame = one 16-byte header + payload:

    !2sBBhBBQ  =  magic "RN" | version | type | wid | flags | codec | length

Frame types: HELLO / WELCOME / READY for rendezvous, WEIGHTS (master →
worker), GRAD (worker → master; with τ > 1 the payload stacks
[grad|w|v]), WSTATE (sync-family start-of-exchange weights), HEARTBEAT,
DONE / BYE for shutdown, ERROR, SEGMENT / PEERS for the p2p data plane,
CENTER for the p2p control plane, CLOCK for trace clock alignment.

Array payloads are float64 in two codecs:

 * ``none``    — raw bytes: ``sendall`` takes a memoryview of the host
   buffer, ``recv_into`` lands in the receiver's preallocated buffer;
 * ``sign_ef`` — 1-bit sign compression with error feedback
   (``core.compression.sign_ef_encode_np``), the EF state kept per link
   and direction.

Rows on the card. The wire moves host bytes; the rows live on the run's
device. ``HostRow`` is the staging buffer between them: pinned host memory
allocated once per link and direction (a plain CPU tensor when the run is
on the CPU), whose numpy view is what ``sendall`` reads and ``recv_into``
writes. ``HostRow.put`` copies a device row into it and ``HostRow.get``
copies it out to a device row; both copies are synchronous
(``non_blocking=False``), so a D2H copy has landed before ``sendall`` reads
the buffer and an H2D copy has read the buffer before the next
``recv_into`` overwrites it.
"""
from __future__ import annotations

import json
import socket
import struct
import threading
import time

import numpy as np
import torch

from repro_torch.core.compression import (
    sign_ef_decode_np,
    sign_ef_encode_np,
    sign_ef_wire_nbytes,
)
from repro_torch.obs.metrics import Slot  # noqa: F401 — the Link counter
#                                           protocol's cell

MAGIC = b"RN"
VERSION = 1
_HEADER = struct.Struct("!2sBBhBBQ")
HEADER_SIZE = _HEADER.size                      # 16

# frame types
HELLO = 1
WELCOME = 2
READY = 3
WEIGHTS = 4
GRAD = 5
WSTATE = 6
HEARTBEAT = 7
DONE = 8
BYE = 9
ERROR = 10
SEGMENT = 11        # p2p data plane: one Message of a Schedule round over a
#                     worker↔worker link; the round index (mod 0x8000)
#                     rides the header's wid field as a desync detector
#                     (the link itself identifies the peer); payload is the
#                     Message.span slice of the sender's mailbox row
PEERS = 12          # p2p handshake on a worker↔worker link: JSON
#                     {"wid", "token"} from the connector, {"wid"} ack back
CENTER = 13         # p2p control plane: worker 0 → master, the center
#                     replica at an eval round (finality is by count — the
#                     master knows the eval schedule it shipped in WELCOME)
CLOCK = 14          # clock-sync probe (obs.clock): empty worker→master ping,
#                     master echoes {"t": perf_counter()} — offset = t −
#                     (t0+t1)/2 at min rtt aligns trace timelines
STATS = 15          # the live telemetry plane's snapshot request and
RECONFIGURE = 16    # elastic membership's epoch directive: reserved for
#                     the reference's frames, not sent by this port yet

FRAME_NAMES = {HELLO: "HELLO", WELCOME: "WELCOME", READY: "READY",
               WEIGHTS: "WEIGHTS", GRAD: "GRAD", WSTATE: "WSTATE",
               HEARTBEAT: "HEARTBEAT", DONE: "DONE", BYE: "BYE",
               ERROR: "ERROR", SEGMENT: "SEGMENT", PEERS: "PEERS",
               CENTER: "CENTER", CLOCK: "CLOCK", STATS: "STATS",
               RECONFIGURE: "RECONFIGURE"}

CODEC_NONE = 0
CODEC_SIGN_EF = 1
CODECS = {"none": CODEC_NONE, "sign_ef": CODEC_SIGN_EF}

_COUNT_LOCK = threading.Lock()    # guards every counters-dict update (the
#                                   dicts are shared across links/threads)


class WireError(ConnectionError):
    """Framing violation or peer gone."""


class DialError(ConnectionError):
    """A bounded retry-with-backoff dial exhausted its deadline."""


def dial_with_backoff(host, port, deadline_s=30.0, base_s=0.05, max_s=1.0,
                      seed=None):
    """Dial ``(host, port)`` with jittered exponential backoff until
    ``deadline_s`` elapses, then raise :class:`DialError` naming the target.

    A staggered multi-host start means the listener may simply not exist yet
    — ``ConnectionRefusedError``/timeouts are retried; anything else (bad
    address family, unreachable network after the deadline) surfaces as
    ``DialError`` with the last underlying error attached.
    """
    deadline = time.monotonic() + deadline_s
    # deterministic per-target jitter stream: retry storms from P dialers
    # de-synchronize without a global RNG (and without perturbing the run's
    # seeded math)
    rng = np.random.default_rng(
        seed if seed is not None else (hash((host, int(port))) & 0xFFFFFFFF))
    delay = base_s
    attempt = 0
    last_exc = None
    while True:
        attempt += 1
        try:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            return socket.create_connection(
                (host, int(port)), timeout=min(max(remaining, 0.01), 10.0))
        except (ConnectionRefusedError, ConnectionResetError, OSError) as exc:
            last_exc = exc
            if time.monotonic() >= deadline:
                break
            sleep_s = min(delay, max_s) * (0.5 + float(rng.random()))
            time.sleep(min(sleep_s, max(deadline - time.monotonic(), 0.0)))
            delay *= 2.0
    raise DialError(
        f"dial to {host}:{port} failed after {attempt} attempts over "
        f"{deadline_s:.1f}s: {last_exc!r}")


class Frame:
    __slots__ = ("ftype", "wid", "flags", "codec", "size")

    def __init__(self, ftype, wid, flags, codec, size):
        self.ftype = ftype
        self.wid = wid
        self.flags = flags
        self.codec = codec
        self.size = size

    def __repr__(self):
        return (f"Frame({FRAME_NAMES.get(self.ftype, self.ftype)}, "
                f"wid={self.wid}, codec={self.codec}, size={self.size})")


def sleep_until(deadline: float) -> None:
    """Absolute-deadline sleep on the ``time.monotonic`` clock (oversleep on
    a loaded box does not accumulate — the PS runtime's discipline)."""
    dt = deadline - time.monotonic()
    if dt > 0:
        time.sleep(dt)


def parse_header(buf: bytes) -> Frame:
    """Validate and unpack one 16-byte frame header (the p2p round engine
    fills header buffers itself on non-blocking sockets)."""
    magic, ver, ftype, wid, flags, codec, size = _HEADER.unpack(buf)
    if magic != MAGIC or ver != VERSION:
        raise WireError(f"bad frame header: magic={magic!r} v={ver}")
    return Frame(ftype, wid, flags, codec, size)


def _recv_exact(sock: socket.socket, view: memoryview) -> None:
    """Fill ``view`` completely, looping over partial reads."""
    got = 0
    n = len(view)
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise WireError("peer closed mid-frame "
                            f"({got}/{n} bytes received)")
        got += k


class Link:
    """One framed endpoint: send lock (header+payload atomic per frame),
    per-direction error-feedback state, byte/message counters, last-seen
    timestamp (heartbeats refresh it)."""

    def __init__(self, sock: socket.socket, codec: str = "none",
                 counters=None):
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            pass                        # AF_UNIX socketpair (tests) — no Nagle
        self.sock = sock
        self.codec = CODECS[codec]
        self.counters = counters            # cells with .value, or None
        self.last_seen = time.monotonic()
        self.hb_telemetry: dict = {}        # last HEARTBEAT payload (worker
        #                                     iteration-rate / exposed-comm
        #                                     gauges — see net/worker.py)
        self.raw_bytes_out = 0              # pre-codec payload bytes encoded
        self.wire_bytes_out = 0             # post-codec payload bytes encoded
        self._send_lock = threading.Lock()
        self._hdr_buf = bytearray(HEADER_SIZE)
        self._ef = {}                       # payload size -> EF state (send)

    # -- send ---------------------------------------------------------------

    def _count(self, nbytes: int) -> None:
        if self.counters is not None:
            # locked: counts may run concurrently — a send and a receive on
            # one link (the p2p threaded-sender path), or several links
            # sharing one counters dict (the master's P reader threads) —
            # and `slot.value += n` alone loses increments between threads.
            # One module-wide lock keeps any sharing pattern exact; at
            # frame granularity the contention cost is noise.
            with _COUNT_LOCK:
                self.counters["messages"].value += 1
                self.counters["wire_bytes"].value += HEADER_SIZE + nbytes
                extra = self.counters.get("link_bytes")
                if extra is not None:   # an additional per-link-class slot
                    extra.value += HEADER_SIZE + nbytes

    def _send(self, ftype: int, wid: int, flags: int, codec: int,
              payload) -> int:
        header = _HEADER.pack(MAGIC, VERSION, ftype, wid, flags, codec,
                              len(payload))
        with self._send_lock:
            self.sock.sendall(header)
            if len(payload):
                self.sock.sendall(payload)
        self._count(len(payload))
        return len(payload)

    def send_simple(self, ftype: int, wid: int = 0) -> int:
        return self._send(ftype, wid, 0, CODEC_NONE, b"")

    def send_json(self, ftype: int, obj, wid: int = 0) -> int:
        return self._send(ftype, wid, 0, CODEC_NONE,
                          json.dumps(obj).encode())

    def encode_array(self, ftype: int, arr: np.ndarray, wid: int = 0,
                     segments: int = 1, ef_tag=0, raw: bool = False
                     ) -> tuple[bytes, memoryview]:
        """Serialize an array frame WITHOUT sending: ``(header, payload)``.
        The p2p round engine queues these on non-blocking sockets and
        streams them itself. With codec none the payload is a zero-copy
        memoryview of ``arr``; sign_ef encodes (and therefore snapshots)
        the data here, advancing this link's error-feedback state — so
        encode order must be deterministic (it is: plan order)."""
        arr = np.ascontiguousarray(arr, np.float64)
        if self.codec == CODEC_SIGN_EF and not raw:
            assert arr.size % max(segments, 1) == 0, (arr.size, segments)
            segs = arr.reshape(max(segments, 1), -1)
            parts = []
            for i in range(segs.shape[0]):
                key = (ftype, segs.shape[1], i, ef_tag)
                err = self._ef.get(key)
                if err is None:
                    err = self._ef[key] = np.zeros(segs.shape[1], np.float64)
                payload, self._ef[key] = sign_ef_encode_np(segs[i], err)
                parts.append(payload)
            payload = memoryview(b"".join(parts))
            codec = CODEC_SIGN_EF
        else:
            payload = memoryview(arr).cast("B")
            codec = CODEC_NONE
        header = _HEADER.pack(MAGIC, VERSION, ftype, wid, max(segments, 1),
                              codec, len(payload))
        # compression-ratio accounting (obs.metrics): raw vs on-the-wire
        # payload bytes, per link. Encode sites are single-threaded per
        # link (plan order / the send path), so plain adds are exact.
        self.raw_bytes_out += arr.nbytes
        self.wire_bytes_out += len(payload)
        return header, payload

    def ef_ratio(self):
        """Measured compression ratio raw/wire of everything this link
        encoded (≈ 64 for pure sign_ef streams; None before any send)."""
        if not self.wire_bytes_out:
            return None
        return self.raw_bytes_out / self.wire_bytes_out

    def send_array(self, ftype: int, arr: np.ndarray, wid: int = 0,
                   segments: int = 1, ef_tag=0, raw: bool = False) -> int:
        """Send a flat float64 array through the link's codec. Returns the
        payload byte count that actually crossed the wire.

        ``segments``: number of equal-size logical segments in ``arr``
        (τ>1 exchanges stack [grad|w|v] into one frame). sign_ef encodes
        EACH segment with its own scale and error-feedback state — one
        shared scale would let weight magnitudes drown the gradient's.
        EF state is keyed by (frame type, segment, ef_tag), so e.g. a
        WSTATE weights stream never shares residuals with a GRAD stream of
        the same size. ``ef_tag`` (any hashable) distinguishes same-size
        streams of one frame type on one link: the p2p data plane tags
        SEGMENT frames with (bucket, chunk index, op), so every (peer,
        bucket, vector segment, direction-of-flow) carries its own
        quantization residual forward. ``raw=True`` bypasses a lossy codec
        for this one frame — one-shot reports (the p2p final CENTER/WSTATE)
        must arrive exact; error feedback can only amortize quantization
        across a STREAM."""
        header, payload = self.encode_array(ftype, arr, wid=wid,
                                            segments=segments, ef_tag=ef_tag,
                                            raw=raw)
        with self._send_lock:
            self.sock.sendall(header)
            if len(payload):
                self.sock.sendall(payload)
        self._count(len(payload))
        return len(payload)

    # -- recv ---------------------------------------------------------------

    def recv_header(self, skip_heartbeat: bool = True) -> Frame:
        while True:
            _recv_exact(self.sock, memoryview(self._hdr_buf))
            magic, ver, ftype, wid, flags, codec, size = _HEADER.unpack(
                bytes(self._hdr_buf))
            if magic != MAGIC or ver != VERSION:
                raise WireError(f"bad frame header: magic={magic!r} v={ver}")
            self.last_seen = time.monotonic()
            frame = Frame(ftype, wid, flags, codec, size)
            if skip_heartbeat and ftype == HEARTBEAT:
                if frame.size:
                    # telemetry-bearing heartbeat (worker iteration rate /
                    # exposed-comm gauges): latch the payload instead of
                    # discarding — the master reads link.hb_telemetry
                    try:
                        self.hb_telemetry = json.loads(
                            bytes(self.recv_payload(frame)).decode())
                    except ValueError:
                        pass
                continue
            return frame

    def recv_payload(self, frame: Frame) -> bytearray:
        buf = bytearray(frame.size)
        if frame.size:
            _recv_exact(self.sock, memoryview(buf))
        self._count(frame.size)
        return buf

    def recv_discard(self, frame: Frame) -> None:
        if frame.size:
            self.recv_payload(frame)

    def recv_json(self, frame: Frame) -> dict:
        return json.loads(bytes(self.recv_payload(frame)).decode())

    def recv_array(self, frame: Frame, out: np.ndarray | None = None
                   ) -> np.ndarray:
        """Decode an array payload. With codec none and a preallocated
        ``out``, the socket writes STRAIGHT into the target buffer
        (``recv_into`` — the zero-copy big-buffer path)."""
        if frame.codec == CODEC_NONE:
            n = frame.size // 8
            if out is not None:
                assert out.dtype == np.float64 and out.size == n, \
                    (out.dtype, out.size, n)
                _recv_exact(self.sock, memoryview(out).cast("B"))
                self._count(frame.size)
                return out
            buf = self.recv_payload(frame)
            return np.frombuffer(buf, np.float64)
        if frame.codec == CODEC_SIGN_EF:
            buf = self.recv_payload(frame)
            arr = decode_array_payload(frame, buf)
            if out is not None:
                out[:] = arr
                return out
            return arr
        raise WireError(f"unknown payload codec {frame.codec}")

    def close(self) -> None:
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()


def decode_array_payload(frame: Frame, buf) -> np.ndarray:
    """Decode a fully-received sign_ef payload buffer (shared by
    ``Link.recv_array`` and the p2p round engine, which fills its own
    buffers on non-blocking sockets)."""
    if frame.flags <= 1:
        return sign_ef_decode_np(buf)
    mv = memoryview(buf)                # per-segment scales (see send_array)
    parts, off = [], 0
    for _ in range(frame.flags):
        n_i = int(np.frombuffer(mv[off:off + 8], np.uint64)[0])
        nb = sign_ef_wire_nbytes(n_i)
        parts.append(sign_ef_decode_np(mv[off:off + nb]))
        off += nb
    return np.concatenate(parts)


# ---------------------------------------------------------------------------
# link micro-benchmark — the measured α–β of a real socket pair, reported by
# ``ps.calibrate`` for the DES comparison (the emulated-wire deadline pacing
# COMPOSES with this: pacing sleeps only the excess over the real transfer).
# ---------------------------------------------------------------------------

def measure_link(host: str = "127.0.0.1", reps: int = 40,
                 big_bytes: int = 4_000_000) -> tuple[float, float]:
    """(alpha_s, beta_s_per_byte) of a loopback/host TCP link, measured with
    this module's own framing: α from small-frame round-trips, β from a
    one-way big-buffer transfer."""
    srv = socket.socket()
    srv.bind((host, 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    out = {}

    def _echo():
        conn, _ = srv.accept()
        link = Link(conn)
        small = np.zeros(8, np.float64)
        for _ in range(reps):
            f = link.recv_header()
            link.recv_array(f, small)
            link.send_array(WEIGHTS, small)
        f = link.recv_header()
        big = link.recv_array(f)
        out["big_ok"] = big.size
        link.send_simple(BYE)
        link.close()

    th = threading.Thread(target=_echo, daemon=True)
    th.start()
    cli = Link(socket.create_connection((host, port), timeout=10))
    small = np.zeros(8, np.float64)
    cli.send_array(WEIGHTS, small)          # warm the path
    cli.recv_array(cli.recv_header(), small)
    t0 = time.perf_counter()
    for _ in range(reps - 1):
        cli.send_array(WEIGHTS, small)
        cli.recv_array(cli.recv_header(), small)
    alpha = (time.perf_counter() - t0) / (reps - 1) / 2   # one-way
    big = np.zeros(big_bytes // 8, np.float64)
    t0 = time.perf_counter()
    cli.send_array(GRAD, big)
    f = cli.recv_header()                   # BYE: peer finished reading
    cli.recv_discard(f)
    beta = (time.perf_counter() - t0 - alpha) / big_bytes
    cli.close()
    srv.close()
    th.join(timeout=5)
    return max(alpha, 1e-7), max(beta, 1e-12)


# ---------------------------------------------------------------------------
# staging between device rows and the wire
# ---------------------------------------------------------------------------

class HostRow:
    """A preallocated f64 host buffer of ``n`` elements for one link
    direction: pinned when ``device`` is a GPU. ``np`` is its numpy view
    (what the wire reads and writes), ``t`` the tensor behind it."""

    __slots__ = ("t", "np")

    def __init__(self, n: int, device):
        pin = torch.device(device).type == "cuda"
        self.t = torch.zeros(int(n), dtype=torch.float64, pin_memory=pin)
        self.np = self.t.numpy()

    def put(self, *rows) -> np.ndarray:
        """Copy device ``rows`` end to end into the buffer; returns the
        filled numpy view, complete when this returns."""
        off = 0
        for r in rows:
            k = r.numel()
            self.t[off:off + k].copy_(r)
            off += k
        return self.np[:off]

    def get(self, *rows) -> None:
        """Copy the buffer out to device ``rows`` (in order), complete —
        the buffer may be overwritten when this returns."""
        off = 0
        for r in rows:
            k = r.numel()
            r.copy_(self.t[off:off + k])
            off += k
