"""The p2p data plane: workers execute ``Schedule.rounds`` over direct
worker↔worker TCP links, bucket by bucket (the port of
``repro/net/peer.py``).

Each worker owns one mailbox row on its device. For every ``Message``
whose ``src`` is this worker, the ``Message.span`` slice of the row goes
out as a SEGMENT frame on the persistent link to ``dst``; for every
message whose ``dst`` is this worker, the slice is received and combined
(``add`` / ``set``). The master only coordinates (rendezvous, eval
reports, heartbeats, shutdown).

Wiring: each worker opens a peer listener before HELLO and advertises it;
WELCOME carries the directory and the resolved rounds. For each pair that
appears in the rounds the higher wid dials the lower's listener (PEERS
handshake: ``{"wid", "token"}`` out, ``{"wid"}`` back), and every dial is
issued before anyone blocks in accept, so setup cannot deadlock.

Buckets: ``set_rounds`` takes element boundaries that cut the row into
buckets; each bucket runs the same rounds with every span clipped to it,
so every element sees the same ops in the same order as the monolithic
exchange (bitwise equal rows). ``execute_exchange`` streams buckets in
order and reports each completion through ``on_bucket``: the caller
updates bucket b while bucket b + 1 is on the wire.

Round engine: a round's sends and receives progress together on
non-blocking sockets under ``select``. Rows on the card go through host
staging: at the start of a round every send span is copied into its own
pinned ``HostRow`` (the snapshot of the pre-round values), every receive
lands in its own pinned ``HostRow`` (or a decoded sign-EF array), and
only when the round is complete are the receives copied to the device and
applied (no schedule sends one worker two messages over one element in a
round, so the order of the applies does not matter). The round ends with
a synchronise of the calling thread's current stream, so the staging
buffers are free for the next round and the row is final when
``on_bucket`` fires. Receives applied after the sends' snapshot is the
pre-round-value discipline of ``comm.rounds.execute_rounds``: every
worker's row ends bitwise equal to the centralized ``mailbox[0]``.

Elastic membership: a dead peer fails the round (``WireError``);
``reset`` closes every peer link but keeps the listener, so each survivor
still blocked in the doomed exchange falls out too, and ``connect`` +
``set_rounds`` rewire the mesh for the next epoch. ``abort`` pulls the
comm thread out of an exchange from another thread (``MeshAbort``).
"""
from __future__ import annotations

import select
import socket
import threading
from time import monotonic as _monotonic

import torch

from repro_torch.comm.rounds import MASTER, bucket_rounds, clip_span
from repro_torch.net import wire
from repro_torch.net.wire import HostRow, Link
from repro_torch.obs import trace as _trace

# socket-op granularity of the round engine: one non-blocking send() hands
# the kernel at most this many bytes, so one link cannot monopolize a
# round's progress loop (a fairness knob; correctness never depends on it)
SEND_OP_MAX = 256 * 1024


class MeshAbort(Exception):
    """The mesh was asked to abandon the exchange in flight (elastic
    reconfiguration): not a wire failure — the caller rewires and
    resumes."""


def predicted_link_bytes(rounds, padded_elements: int,
                         boundaries=None) -> dict:
    """Exact wire bytes (header + raw f64 payload) per unordered worker
    pair for ONE exchange of ``rounds`` under codec none — what each
    endpoint's per-link counter reports (sends and receives). With
    ``boundaries`` each non-empty clip of a message is its own frame."""
    bounds = [0, padded_elements] if boundaries is None \
        else [int(x) for x in boundaries]
    out: dict[tuple, int] = {}
    for rnd in rounds:
        for m in rnd:
            if m.src == MASTER or m.dst == MASTER:
                continue
            pair = (min(m.src, m.dst), max(m.src, m.dst))
            for lo, hi in zip(bounds[:-1], bounds[1:]):
                span = clip_span(m, padded_elements, lo, hi)
                if span is None:
                    continue
                a, b = span
                out[pair] = out.get(pair, 0) + wire.HEADER_SIZE + (b - a) * 8
    return out


class _LinkIO:
    """Per-link engine state for one round: a FIFO of outgoing frame
    buffers and a FIFO of expected incoming segments, each with a byte
    cursor — resumable whenever ``select`` says the socket is ready."""

    __slots__ = ("link", "send_q", "send_vi", "send_off", "recv_q",
                 "hdr_buf", "hdr_got", "frame", "pay_view", "pay_buf",
                 "pay_got")

    def __init__(self, link: Link):
        self.link = link
        self.send_q: list = []       # [[views...], payload_len]
        self.send_vi = 0             # view index within the head frame
        self.send_off = 0            # byte offset within the current view
        self.recv_q: list = []       # (a, b, op, host)
        self.hdr_buf = bytearray(wire.HEADER_SIZE)
        self.hdr_got = 0
        self.frame = None
        self.pay_view = None
        self.pay_buf = None
        self.pay_got = 0


class PeerMesh:
    """One worker's endpoint of the p2p data plane: listener, persistent
    links to every peer its rounds talk to, and the bucketed round
    executor over a row on ``device``."""

    def __init__(self, wid: int, token: str, codec: str = "none",
                 bind_host: str = "0.0.0.0", port: int = 0,
                 timeout_s: float = 600.0, device="cpu"):
        self.wid = wid
        self.token = token
        self.codec = codec
        self.timeout_s = timeout_s
        self.device = torch.device(device)
        self.listener = socket.socket()
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.listener.bind((bind_host, port))
        except OSError:
            # bind_host is the interface the master link runs over; if it
            # is not bindable (a NAT'd advertisement), bind any
            self.listener.bind(("0.0.0.0", port))
        self.listener.listen(16)
        self.port = self.listener.getsockname()[1]
        self.links: dict[int, Link] = {}
        self.counters: dict[int, dict] = {}
        self.rounds_executed = 0
        self.bucket_send_bytes: list[int] = []   # logical f64 payload sent,
        #                                          per bucket, all exchanges
        self.boundaries: list[int] = []
        self._plans: list = []           # per bucket: [(sends, recvs)]/round
        self._rounds_len = 0
        self._nonblocking = False
        self._abort = threading.Event()  # elastic: set from another thread
        #                                  to pull the comm thread out of a
        #                                  doomed exchange
        self.tracer = None               # obs.trace.Tracer of the comm
        #                                  thread (None = tracing off)
        self.host_of = None              # wid -> host (set by the worker
        #                                  when WELCOME ships a topology):
        #                                  stats() then labels each peer
        #                                  link "intra" or "cross"

    # -- mesh setup ----------------------------------------------------------

    def _register(self, peer: int, sock: socket.socket) -> Link:
        sock.settimeout(self.timeout_s)
        link = Link(sock, codec=self.codec)
        self.links[peer] = link
        return link

    def connect(self, directory: dict, pairs) -> None:
        """One persistent link per pair involving this worker.
        ``directory``: wid -> (host, port). The higher wid dials, the
        lower accepts; all dials go out before this worker blocks in
        accept."""
        dial = sorted(p for (p, q) in pairs if q == self.wid)
        expect = {q for (p, q) in pairs if p == self.wid}
        dialed = {}
        for peer in dial:                # dials complete against backlogs
            host, port = directory[str(peer)] if str(peer) in directory \
                else directory[peer]
            sock = wire.dial_with_backoff(
                host, port, deadline_s=min(self.timeout_s, 60.0),
                seed=(self.wid << 16) | peer)
            link = self._register(peer, sock)
            link.send_json(wire.PEERS, {"wid": self.wid, "token": self.token},
                           wid=self.wid)
            dialed[peer] = link
        deadline = _monotonic() + self.timeout_s
        self.listener.settimeout(1.0)
        while expect:
            if _monotonic() > deadline:
                raise wire.WireError(
                    f"p2p mesh setup timeout: still waiting for peers "
                    f"{sorted(expect)} to dial worker {self.wid}")
            try:
                conn, _ = self.listener.accept()
            except socket.timeout:
                continue
            # a stray connection must neither crash the worker nor stall
            # the accept loop: short handshake timeout, errors close it
            conn.settimeout(10.0)
            probe = Link(conn, codec=self.codec)
            try:
                frame = probe.recv_header()
                if frame.ftype != wire.PEERS:
                    probe.close()
                    continue
                hello = probe.recv_json(frame)
                peer = int(hello.get("wid", -99))
                if hello.get("token") != self.token or peer not in expect:
                    probe.send_json(wire.ERROR,
                                    {"msg": f"bad peer hello {peer}"})
                    probe.close()
                    continue
                probe.send_json(wire.PEERS, {"wid": self.wid}, wid=self.wid)
            except (socket.timeout, wire.WireError, OSError, ValueError):
                probe.close()
                continue
            conn.settimeout(self.timeout_s)
            self.links[peer] = probe
            expect.discard(peer)
        for peer, link in dialed.items():          # acks from the acceptors
            frame = link.recv_header()
            if frame.ftype != wire.PEERS:
                raise wire.WireError(
                    f"peer {peer} rejected the handshake: "
                    f"{wire.FRAME_NAMES.get(frame.ftype, frame.ftype)}")
            ack = link.recv_json(frame)
            if int(ack["wid"]) != peer:
                raise wire.WireError(f"peer {peer} answered as {ack}")
        # counters attach only now: the stats count SEGMENT traffic, not
        # the handshake (predicted_link_bytes prices the data plane alone).
        # setdefault: an elastic rewire reuses the cells, so per-peer byte
        # counts stay cumulative across epochs
        for peer, link in self.links.items():
            link.counters = self.counters.setdefault(
                peer, {"messages": wire.Slot(), "wire_bytes": wire.Slot()})

    # -- the round executor --------------------------------------------------

    @property
    def n_buckets(self) -> int:
        return len(self._plans)

    def set_rounds(self, rounds: list, padded: int,
                   boundaries=None) -> None:
        """Precompute the per-bucket, per-round send / receive plans and
        their staging buffers, so execution allocates no host memory:
        sends are ``(link, a, b, ef_tag, host)``, receives ``(link, a, b,
        op, host)``. Staging is keyed by (peer, span): rounds run one after
        another, so a key's buffer is free again when it recurs. The
        sign-EF tag is (bucket, chunk, op): a ring link carries a chunk's
        reduce-scatter partial sums and its all-gather values, streams
        whose quantization residuals must not mix."""
        bounds = [0, padded] if boundaries is None \
            else [int(x) for x in boundaries]
        self.boundaries = bounds
        self._rounds_len = len(rounds)
        self._plans = []
        self.bucket_send_bytes = [0] * (len(bounds) - 1)
        staging: dict = {}

        def _host(key, size):
            if key not in staging:
                staging[key] = HostRow(size, self.device)
            return staging[key]

        for bidx, plan in enumerate(bucket_rounds(rounds, padded, bounds)):
            rplan = []
            for rnd in plan:
                sends, recvs = [], []
                for m, (a, b) in rnd:
                    if m.src == self.wid:
                        sends.append((self.links[m.dst], a, b,
                                      (bidx, m.chunk, m.op),
                                      _host(("send", m.dst, a, b), b - a)))
                    elif m.dst == self.wid:
                        recvs.append((self.links[m.src], a, b, m.op,
                                      _host(("recv", m.src, a, b), b - a)))
                rplan.append((sends, recvs))
            self._plans.append(rplan)

    def _ensure_nonblocking(self) -> None:
        if not self._nonblocking:
            for link in self.links.values():
                link.sock.setblocking(False)
            self._nonblocking = True

    def _run_round(self, row: torch.Tensor, sends, recvs, seq: int) -> None:
        """Snapshot every send span into its staging buffer, progress every
        send and receive of the round under ``select`` until all complete,
        then apply the receives to the row. Frame order per
        link is plan order on both ends, and the round index rides the
        header's wid field as a desync detector."""
        ios: dict[Link, _LinkIO] = {}
        for link, a, b, tag, host in sends:
            io = ios.get(link)
            if io is None:
                io = ios[link] = _LinkIO(link)
            header, payload = link.encode_array(
                wire.SEGMENT, host.put(row[a:b]), wid=seq, ef_tag=tag)
            io.send_q.append([[memoryview(header), payload], len(payload)])
        for link, a, b, op, host in recvs:
            io = ios.get(link)
            if io is None:
                io = ios[link] = _LinkIO(link)
            io.recv_q.append((a, b, op, host))
        by_sock = {io.link.sock: io for io in ios.values()}
        landed = []                      # (a, b, op, host tensor) post-round
        deadline = _monotonic() + self.timeout_s
        while True:
            if self._abort.is_set():
                raise MeshAbort(f"exchange aborted at round {seq}")
            rl = [s for s, io in by_sock.items() if io.recv_q]
            wl = [s for s, io in by_sock.items() if io.send_q]
            if not rl and not wl:
                break
            readable, writable, _ = select.select(rl, wl, [], 1.0)
            if not readable and not writable:
                if _monotonic() > deadline:
                    raise wire.WireError(
                        f"p2p round {seq} stalled on worker {self.wid}: "
                        f"{len(rl)} recv / {len(wl)} send links pending")
                continue
            for s in writable:
                self._pump_send(by_sock[s])
            for s in readable:
                self._pump_recv(by_sock[s], seq, landed)
        for a, b, op, src in landed:     # the row changes only after every
            seg = src.to(row.device)     # send of the round snapshot it
            if op == "set":
                row[a:b].copy_(seg)
            else:
                row[a:b].add_(seg)
        if row.device.type == "cuda":
            torch.cuda.current_stream(row.device).synchronize()

    @staticmethod
    def _pump_send(io: _LinkIO) -> None:
        sock = io.link.sock
        while io.send_q:
            views, payload_len = io.send_q[0]
            view = views[io.send_vi]
            chunk = view[io.send_off:io.send_off + SEND_OP_MAX]
            try:
                k = sock.send(chunk)
            except (BlockingIOError, InterruptedError):
                return
            io.send_off += k
            if io.send_off < len(view):
                if k < len(chunk):       # kernel buffer full: come back
                    return
                continue
            io.send_vi += 1
            io.send_off = 0
            if io.send_vi == len(views):
                io.link._count(payload_len)
                io.send_q.pop(0)
                io.send_vi = 0

    @staticmethod
    def _pump_recv(io: _LinkIO, seq: int, landed: list) -> None:
        sock = io.link.sock
        while io.recv_q:
            if io.frame is None:         # header phase
                mv = memoryview(io.hdr_buf)
                try:
                    k = sock.recv_into(mv[io.hdr_got:])
                except (BlockingIOError, InterruptedError):
                    return
                if k == 0:
                    raise wire.WireError(f"peer closed mid-round "
                                         f"(round {seq})")
                io.hdr_got += k
                if io.hdr_got < wire.HEADER_SIZE:
                    return
                io.hdr_got = 0
                frame = wire.parse_header(bytes(io.hdr_buf))
                if frame.ftype != wire.SEGMENT or frame.wid != seq:
                    raise wire.WireError(
                        f"p2p desync: expected SEGMENT round {seq}, got "
                        f"{wire.FRAME_NAMES.get(frame.ftype, frame.ftype)} "
                        f"round {frame.wid}")
                a, b, op, host = io.recv_q[0]
                if frame.codec == wire.CODEC_NONE:
                    if frame.size != (b - a) * 8:
                        raise wire.WireError(
                            f"p2p segment size {frame.size} != span "
                            f"{(b - a) * 8} (round {seq})")
                    io.pay_view = memoryview(host.np).cast("B")
                    io.pay_buf = None
                else:
                    io.pay_buf = bytearray(frame.size)
                    io.pay_view = memoryview(io.pay_buf)
                io.pay_got = 0
                io.frame = frame
            frame = io.frame
            if io.pay_got < frame.size:
                try:
                    k = sock.recv_into(io.pay_view[io.pay_got:])
                except (BlockingIOError, InterruptedError):
                    return
                if k == 0:
                    raise wire.WireError(f"peer closed mid-segment "
                                         f"(round {seq})")
                io.pay_got += k
                if io.pay_got < frame.size:
                    return
            a, b, op, host = io.recv_q.pop(0)
            io.frame = None
            io.link._count(frame.size)
            if io.pay_buf is not None:   # sign_ef: decode on the host
                src = torch.from_numpy(
                    wire.decode_array_payload(frame, io.pay_buf))
                io.pay_buf = None
            else:
                src = host.t
            landed.append((a, b, op, src))
            io.pay_view = None

    def execute_bucket(self, row: torch.Tensor, bidx: int) -> None:
        """All rounds of one bucket, in schedule order (call in bucket
        order: frame sequence numbers advance bucket-major)."""
        self._ensure_nonblocking()
        for r_idx, (sends, recvs) in enumerate(self._plans[bidx]):
            if not sends and not recvs:
                continue
            seq = (bidx * self._rounds_len + r_idx) & 0x7FFF
            for _, a, b, _tag, _host in sends:
                self.bucket_send_bytes[bidx] += (b - a) * 8
            self._run_round(row, sends, recvs, seq)

    def execute_exchange(self, row: torch.Tensor, on_bucket=None) -> None:
        """One all-reduce: every bucket's share of every round,
        bucket-major. ``on_bucket(bidx)`` fires as each bucket's rounds
        complete (its row slice is final): the caller can update bucket
        ``bidx`` while ``bidx + 1`` is on the wire."""
        tr = self.tracer
        for bidx in range(len(self._plans)):
            t0 = tr.now() if tr is not None else 0.0
            self.execute_bucket(row, bidx)
            if on_bucket is not None:
                on_bucket(bidx)              # pacing sleep included: the
            if tr is not None:               # span is the bucket's wire time
                tr.record(_trace.BUCKET, t0, tr.now(), bidx)
        self.rounds_executed += self._rounds_len

    # -- accounting / teardown ----------------------------------------------

    def stats(self) -> dict:
        """Per-link counters, reported to the master in BYE."""
        return {
            "sync_rounds": self.rounds_executed,
            "n_buckets": len(self._plans),
            "bucket_send_bytes": list(self.bucket_send_bytes),
            "peer_links": {
                str(peer): {"messages": c["messages"].value,
                            "wire_bytes": c["wire_bytes"].value,
                            **({"link": ("intra" if self.host_of(peer)
                                         == self.host_of(self.wid)
                                         else "cross")}
                               if self.host_of is not None else {}),
                            **({"ef_ratio": r}
                               if (peer in self.links
                                   and (r := self.links[peer].ef_ratio()))
                               else {})}
                for peer, c in sorted(self.counters.items())},
        }

    def abort(self) -> None:
        """Ask the comm thread to abandon the exchange in flight: the next
        pass of ``_run_round``'s loop (at most 1 s away, the select
        timeout) raises :class:`MeshAbort`. Idempotent; ``reset`` clears
        it."""
        self._abort.set()

    def reset(self) -> None:
        """Tear down every peer link but keep the listener — the elastic
        rewire: an abandoned exchange leaves partial frames in flight, so
        reused sockets would desync the framing; fresh links (and fresh EF
        state, which lives on the Link) are the only safe restart point.
        ``connect`` + ``set_rounds`` rebuild the mesh, and its staging
        buffers, for the new epoch."""
        for link in self.links.values():
            link.close()
        self.links.clear()       # counters stay: cumulative across epochs
        self._plans = []
        self._rounds_len = 0
        self._nonblocking = False
        self._abort.clear()

    def close(self) -> None:
        for link in self.links.values():
            link.close()
        self.links.clear()
        try:
            self.listener.close()
        except OSError:
            pass
