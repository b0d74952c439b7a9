"""Exchange-schedule round structure — the wire pattern as data (the port of
``repro/comm/rounds.py``).

A schedule is a list of ROUNDS; a round is a list of point-to-point
messages that fly concurrently. ``execute_rounds`` runs them over a
mailbox tensor of rows (the PS runtime's mailbox, and the pod rows of the
multi-pod exchange), and ``t_rounds`` prices the same structure under the
α–β model. Rounds, spans and bucket
clipping keep the reference's exact semantics: the runtime's bitwise
parity with ``repro.ps`` depends on every element seeing the same adds
from the same sources in the same order.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import costmodel
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as _trace

MASTER = -1   # the parameter server's own endpoint (round_robin uses it)


@dataclasses.dataclass(frozen=True)
class Message:
    """One point-to-point transfer inside a round.

    ``frac`` is the fraction of the buffer moved. Chunked schedules view the
    buffer as ``chunks`` equal slices and move slice ``chunk`` (None: the
    whole buffer). ``op`` is "add" (accumulate into the receiver) or "set"
    (overwrite); receivers always read the sender's PRE-round value.
    """

    src: int
    dst: int
    frac: float = 1.0
    chunk: int | None = None
    chunks: int = 1
    op: str = "add"

    def span(self, n_elements: int) -> tuple[int, int]:
        """Element offsets ``[start, stop)`` this message moves in an
        ``n_elements`` buffer (``chunks`` must divide it — the runtime pads
        rows to a multiple of P for exactly this)."""
        if self.chunk is None:
            return 0, n_elements
        assert n_elements % self.chunks == 0, (n_elements, self.chunks)
        seg = n_elements // self.chunks
        return self.chunk * seg, (self.chunk + 1) * seg

    def nbytes(self, n_bytes: float) -> float:
        """Payload bytes this message moves out of an n-byte buffer."""
        return self.frac * n_bytes


def round_robin_rounds(p, n_bytes=0.0, net=None, topology=None):
    """2·p serialized master↔worker messages: gather in rank order, then
    broadcast."""
    gather = [[Message(i, MASTER, op="add")] for i in range(p)]
    bcast = [[Message(MASTER, i, op="set")] for i in range(p)]
    return gather + bcast


def tree_rounds(p, n_bytes=0.0, net=None, topology=None):
    rounds = []
    d = 1
    while d < p:
        rounds.append([Message(i + d, i, op="add")
                       for i in range(0, p, 2 * d)])
        d *= 2
    d = p // 2
    while d >= 1:
        rounds.append([Message(i, i + d, op="set")
                       for i in range(0, p, 2 * d)])
        d //= 2
    return rounds


def butterfly_rounds(p, n_bytes=0.0, net=None, topology=None):
    rounds = []
    d = 1
    while d < p:
        rounds.append([Message(i, i ^ d, op="add") for i in range(p)])
        d *= 2
    return rounds


def ring_rounds(p, n_bytes=0.0, net=None, topology=None):
    rounds = []
    for s in range(p - 1):      # reduce-scatter
        rounds.append([Message(r, (r + 1) % p, frac=1.0 / p,
                               chunk=(r - s) % p, chunks=p, op="add")
                       for r in range(p)])
    for s in range(p - 1):      # all-gather
        rounds.append([Message(r, (r + 1) % p, frac=1.0 / p,
                               chunk=(r + 1 - s) % p, chunks=p, op="set")
                       for r in range(p)])
    return rounds


def psum_rounds(p, n_bytes=0.0, net=None, topology=None):
    """Butterfly when the α–β model says latency-bound (and p is a power of
    two), else ring; on a non-uniform topology the two candidates are
    priced round by round over the actual links."""
    net = net or costmodel.PCIE3_X16
    if topology is not None and not topology.uniform:
        if p & (p - 1) == 0:
            btf = butterfly_rounds(p)
            if t_rounds(btf, n_bytes, topology=topology) \
                    <= t_rounds(ring_rounds(p), n_bytes, topology=topology):
                return btf
        return ring_rounds(p)
    if p & (p - 1) == 0 and costmodel.t_butterfly_allreduce(n_bytes, p, net) \
            <= costmodel.t_ring_allreduce(n_bytes, p, net):
        return butterfly_rounds(p)
    return ring_rounds(p)


def inner_size(p: int) -> int:
    """Near-square group size 2^⌈log2(p)/2⌉ of the hierarchical schedule."""
    if p <= 1:
        return 1
    log2p = p.bit_length() - 1
    return 1 << ((log2p + 1) // 2)


def topology_group(p: int, topology=None) -> int:
    """Hierarchical group size: the topology's slot count when it tiles p,
    else the flat near-square split."""
    if topology is not None and topology.hosts > 1 and topology.p == p:
        return topology.slots
    return inner_size(p)


def hierarchical_rounds(p, n_bytes=0.0, net=None, topology=None, group=None):
    """Ring reduce-scatter + all-gather inside each group of ``m`` ranks,
    then a recursive-doubling butterfly across the ``p // m`` groups (whose
    count must be a power of two)."""
    m = int(group) if group is not None else topology_group(p, topology)
    if m < 1 or p % m != 0:
        raise ValueError(
            f"hierarchical group size {m} does not tile p={p}")
    groups = p // m
    if groups & (groups - 1) != 0:
        raise ValueError(
            f"hierarchical needs a power-of-two group count, got "
            f"{groups} groups of {m} for p={p}")
    rounds = []
    for s in range(m - 1):
        rounds.append([Message(g * m + j, g * m + (j + 1) % m, frac=1.0 / m,
                               chunk=(j - s) % m, chunks=m, op="add")
                       for g in range(groups) for j in range(m)])
    for s in range(m - 1):
        rounds.append([Message(g * m + j, g * m + (j + 1) % m, frac=1.0 / m,
                               chunk=(j + 1 - s) % m, chunks=m, op="set")
                       for g in range(groups) for j in range(m)])
    d = 1
    while d < groups:
        rounds.append([Message(g * m + j, (g ^ d) * m + j, op="add")
                       for g in range(groups) for j in range(m)])
        d *= 2
    return rounds


def _link_net(m: Message, net, topology):
    """The network a message rides: its link class under a topology (a
    master endpoint, wid < 0, is its own host: master links are cross),
    else ``net``."""
    return topology.link(m.src, m.dst) if topology is not None else net


def t_rounds(rounds, n_bytes: float, net=None, topology=None,
             wid: int | None = None) -> float:
    """α–β time of a round structure: each round costs the max over its
    messages of ``link.α + frac·n·link.β`` (each message on its own link
    class when a ``topology`` is given); rounds serialize. ``wid`` keeps
    only the messages touching that worker: its own pacing deadline on a
    heterogeneous mesh, where an intra-host pair finishes early and waits
    on its cross-host peers at the blocking recv, not by sleeping."""
    net = net or costmodel.PCIE3_X16
    total = 0.0
    for rnd in rounds:
        worst = None
        for m in rnd:
            if wid is not None and m.src != wid and m.dst != wid:
                continue
            link = _link_net(m, net, topology)
            t = link.alpha + m.frac * n_bytes * link.beta
            if worst is None or t > worst:
                worst = t
        if worst is not None:
            total += worst
    return total


def bytes_from_rounds(rounds, n_bytes: float) -> float:
    """Total payload bytes all messages of ``rounds`` move for an n-byte
    buffer, every message counted: what the p2p per-link byte counters
    add up to."""
    return sum(m.nbytes(n_bytes) for rnd in rounds for m in rnd)


# ---------------------------------------------------------------------------
# bucketed view — the SAME rounds, clipped at bucket boundaries
# ---------------------------------------------------------------------------
#
# Bucketing must not change a bit of the result, so it is a VIEW of the
# monolithic schedule: every message keeps its src/dst/op and its place in
# the round order, and bucket b clips the message's span to [lo_b, hi_b).
# Buckets partition the row, so each element sees the same operations in
# the same order as in the monolithic exchange.

# the reference packer's block (repro/core/packing.py ELASTIC_UPDATE_BLOCK):
# bucket cuts align on it, and parity with the reference needs the same cuts
ELASTIC_UPDATE_ALIGN = 8 * 128 * 128


def default_bucket_boundaries(sizes, n_elements: int,
                              bucket_bytes: int) -> list[int]:
    """The runtime's boundary policy for ``bucket_bytes`` f64 payload bytes
    per bucket: align cuts to ``ELASTIC_UPDATE_ALIGN`` only when the buckets
    themselves are at least that large."""
    target = max(1, int(bucket_bytes) // 8)
    align = ELASTIC_UPDATE_ALIGN if target >= ELASTIC_UPDATE_ALIGN else None
    return bucket_boundaries(sizes, n_elements, target, align=align)


def bucket_boundaries(sizes, n_elements: int, target_elems: int,
                      align: int | None = None) -> list[int]:
    """Cut offsets ``[0, b1, ..., n_elements]`` grouping consecutive layers
    (``sizes``: per-layer element counts) into buckets of ~``target_elems``
    elements; a cut lands on the first layer edge where the open bucket has
    reached the target, rounded UP to a multiple of ``align`` if given.
    No ``sizes``: uniform slabs."""
    assert n_elements > 0 and target_elems > 0
    edges: list[int] = []
    if sizes:
        off = 0
        for s in sizes:
            off += int(s)
            edges.append(off)
    else:
        edges = list(range(target_elems, n_elements, target_elems))
        edges.append(n_elements)
    cuts = [0]
    for e in edges:
        if e >= n_elements:
            break
        if e - cuts[-1] >= target_elems:
            c = e if align is None else -(-e // align) * align
            if cuts[-1] < c < n_elements:
                cuts.append(c)
    cuts.append(n_elements)
    out = [cuts[0]]
    for c in cuts[1:]:
        if c > out[-1]:
            out.append(c)
    return out


def clip_span(m: Message, n_elements: int, lo: int, hi: int
              ) -> tuple[int, int] | None:
    """Intersection of ``m.span(n_elements)`` with bucket ``[lo, hi)``."""
    a, b = m.span(n_elements)
    a, b = max(a, lo), min(b, hi)
    return (a, b) if a < b else None


def bucket_rounds(rounds, n_elements: int, boundaries) -> list:
    """One plan per bucket: a list of rounds of ``(message, (start, stop))``
    pairs clipped to the bucket (empty rounds kept, so round indices stay
    aligned across buckets)."""
    assert boundaries[0] == 0 and boundaries[-1] == n_elements, boundaries
    plans = []
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        plan = []
        for rnd in rounds:
            clipped = []
            for m in rnd:
                span = clip_span(m, n_elements, lo, hi)
                if span is not None:
                    clipped.append((m, span))
            plan.append(clipped)
        plans.append(plan)
    return plans


# ---------------------------------------------------------------------------
# execution over a mailbox of rows
# ---------------------------------------------------------------------------

def _apply_round(mailbox, rnd_spans) -> None:
    """One message round over ``(message, (a, b))`` pairs: receivers read
    the senders' PRE-round values (snapshot every payload, then apply) —
    messages within a round are concurrent."""
    payloads = [(m, a, b, mailbox[m.src, a:b].clone())
                for m, (a, b) in rnd_spans]
    for m, a, b, pay in payloads:
        tgt = mailbox[m.dst, a:b]
        if m.op == "add":
            tgt += pay
        else:
            tgt.copy_(pay)


def execute_rounds(mailbox, n: int, rounds, counters=None,
                   boundaries=None, tracer=None) -> None:
    """Apply one all-reduce — the schedule's message rounds — over the
    mailbox (rows 0..P-1 = workers, row P = the master endpoint used by
    round_robin). With ``boundaries`` the same rounds execute bucket-major
    with every span clipped per bucket: each element sees the same ops in
    the same order, so the result is bitwise the monolithic one. The
    counters are schedule-level either way. ``tracer`` (``obs.trace``)
    records one ROUND span per round, or one BUCKET span per bucket."""
    mailbox[-1].zero_()             # master endpoint accumulates from zero
    row_len = mailbox.shape[-1]
    bucketed = boundaries is not None and len(boundaries) > 2
    if bucketed:
        plans = bucket_rounds(rounds, row_len, boundaries)
    else:
        plans = [[[(m, m.span(row_len)) for m in rnd] for rnd in rounds]]
    for bidx, plan in enumerate(plans):
        t0 = tracer.now() if tracer is not None and bucketed else 0.0
        for r, rnd_spans in enumerate(plan):
            if tracer is not None and not bucketed:
                t0 = tracer.now()
            _apply_round(mailbox, rnd_spans)
            if tracer is not None and not bucketed:
                tracer.record(_trace.ROUND, t0, tracer.now(), r)
        if tracer is not None and bucketed:
            tracer.record(_trace.BUCKET, t0, tracer.now(), bidx)
    if counters is not None:
        for rnd in rounds:
            obs_metrics.count_round(counters, rnd, n)


# ---------------------------------------------------------------------------
# the p2p data plane's view of the rounds
# ---------------------------------------------------------------------------

def t_rounds_buckets(rounds, n_elements: int, boundaries, net=None,
                     topology=None, wid: int | None = None) -> list[float]:
    """Per-bucket α–β time of the bucketed view of ``rounds``, priced as
    ``t_rounds`` prices (``topology``: per link class; ``wid``: that
    worker's messages only): bucket b pays, for every round it appears
    in, the max over its clipped messages of ``link.α + (b − a)·8·link.β``
    — exactly the SEGMENT frames it moves."""
    net = net or costmodel.PCIE3_X16
    out = []
    for plan in bucket_rounds(rounds, n_elements, boundaries):
        t = 0.0
        for rnd in plan:
            worst = None
            for m, (a, b) in rnd:
                if wid is not None and m.src != wid and m.dst != wid:
                    continue
                link = _link_net(m, net, topology)
                tm = link.alpha + (b - a) * 8 * link.beta
                if worst is None or tm > worst:
                    worst = tm
            if worst is not None:
                t += worst
        out.append(t)
    return out


def peer_pairs(rounds) -> list[tuple[int, int]]:
    """The worker↔worker links a round structure needs: unordered (i, j)
    pairs with i < j in first-use order, master-endpoint messages left
    out."""
    pairs: list[tuple[int, int]] = []
    seen = set()
    for rnd in rounds:
        for m in rnd:
            if m.src == MASTER or m.dst == MASTER:
                continue
            pair = (min(m.src, m.dst), max(m.src, m.dst))
            if pair not in seen:
                seen.add(pair)
                pairs.append(pair)
    return pairs


def remap_rounds(rounds, rank_to_wid) -> list:
    """Relabel a round structure built over dense ranks 0..P′−1 onto real
    worker ids (``ft.membership.dense_rank_map``): after a membership
    change the schedules still produce dense indices, but the
    surviving wids are a sparse subset — {0, 1, 3} after wid 2 dies.
    MASTER endpoints pass through. Chunk ownership, fractions and op order
    are untouched, so the remapped structure prices and executes exactly
    like the dense one."""
    def _m(i):
        return MASTER if i == MASTER else rank_to_wid[i]

    return [[dataclasses.replace(m, src=_m(m.src), dst=_m(m.dst))
             for m in rnd] for rnd in rounds]


def rounds_to_wire(rounds) -> list:
    """JSON form of a round structure (the master ships it in WELCOME)."""
    return [[[m.src, m.dst, m.frac, m.chunk, m.chunks, m.op] for m in rnd]
            for rnd in rounds]


def rounds_from_wire(obj) -> list:
    """Inverse of ``rounds_to_wire``."""
    return [[Message(src, dst, frac, chunk, chunks, op)
             for src, dst, frac, chunk, chunks, op in rnd]
            for rnd in obj]
