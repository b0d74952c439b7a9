"""The port's p2p sync data plane on the CPU (``repro_torch.net.peer`` and
the p2p worker loop), against the reference (``repro.net.peer``,
``repro.comm.rounds``, ``repro.ps``).

Under deterministic admission the thread plane, the tcp master plane and
the tcp p2p plane give the same bits, and so does the reference's p2p run;
every peer link carries exactly ``predicted_link_bytes``; the master link
collapses; bucketed exchanges with overlap on and off equal the monolithic
one; the round engine streams rows larger than the socket buffers without
deadlock.
"""
import socket
import threading

import numpy as np
import pytest
import torch

from repro import comm as ref_comm
from repro import ps as ref_ps
from repro.comm import rounds as ref_rounds
from repro.core.easgd import EASGDConfig as RefConfig
from repro.net import peer as ref_peer
from repro_torch.comm import rounds, schedules
from repro_torch.core import costmodel
from repro_torch.core.easgd import EASGDConfig
from repro_torch.net import peer, wire
from repro_torch.ps import problems, runtime

ETA, RHO, MU = 0.05, 0.07, 0.9
CFG = EASGDConfig(eta=ETA, rho=RHO, mu=MU)
REF_CFG = RefConfig(eta=ETA, rho=RHO, mu=MU)


def _cfg(mod, algo, P, plane, schedule, iters, transport="tcp", **kw):
    kw.setdefault("deterministic", True)
    kw.setdefault("eval_every_iters", 10**9)
    return mod.PSConfig(algorithm=algo, n_workers=P, total_iters=iters,
                        transport=transport, schedule=schedule,
                        **({"sync_plane": plane} if transport == "tcp"
                           else {}), **kw)


def _plane_run(algo, P, plane, schedule, iters=48, transport="tcp", **kw):
    return runtime.run_ps(problems.NUMPY_MLP, CFG,
                          _cfg(runtime, algo, P, plane, schedule, iters,
                               transport, **kw), device="cpu")


# ---------------------------------------------------------------------------
# the round structure's wire form and byte prediction (pure)
# ---------------------------------------------------------------------------

SCHEDULES = [("ring", 2), ("ring", 3), ("ring", 4), ("tree", 4),
             ("butterfly", 4), ("round_robin", 3), ("hierarchical", 4)]


@pytest.mark.parametrize("name,P", SCHEDULES)
def test_rounds_wire_form_and_peer_pairs_match_reference(name, P):
    mine = schedules.get(name).rounds(P, 8000.0)
    ref = ref_comm.get(name).rounds(P, 8000.0)
    assert rounds.rounds_to_wire(mine) == ref_rounds.rounds_to_wire(ref)
    assert rounds.peer_pairs(mine) == ref_rounds.peer_pairs(ref)
    back = rounds.rounds_from_wire(rounds.rounds_to_wire(mine))
    assert rounds.rounds_to_wire(back) == rounds.rounds_to_wire(mine)


@pytest.mark.parametrize("name,P", SCHEDULES)
@pytest.mark.parametrize("bounds", [None, "three"])
def test_predicted_link_bytes_match_reference(name, P, bounds):
    padded = 1000 + (-1000) % P
    cuts = None if bounds is None else [0, 333, 700, padded]
    mine = schedules.get(name).rounds(P, padded * 8.0)
    ref = ref_comm.get(name).rounds(P, padded * 8.0)
    assert (peer.predicted_link_bytes(mine, padded, cuts)
            == ref_peer.predicted_link_bytes(ref, padded, cuts))
    if cuts is not None:
        net = costmodel.PS_WIRE
        from repro.core import costmodel as ref_costmodel
        got = rounds.t_rounds_buckets(mine, padded, cuts, net)
        want = ref_rounds.t_rounds_buckets(
            ref, padded, cuts, net=ref_costmodel.Network(
                net.name, net.alpha, net.beta))
        np.testing.assert_allclose(got, want, rtol=1e-12)


# ---------------------------------------------------------------------------
# the mesh alone, two workers in threads
# ---------------------------------------------------------------------------

def _mesh_exchange(rows, rnds, boundaries=None, codec="none"):
    """Run one exchange of ``rnds`` over real meshes, one thread per
    worker; returns the rows and each mesh's stats."""
    P = len(rows)
    meshes = [peer.PeerMesh(w, "t", codec=codec, bind_host="127.0.0.1",
                            timeout_s=30) for w in range(P)]
    directory = {w: ("127.0.0.1", m.port) for w, m in enumerate(meshes)}
    errs, stats, threads = [], {}, []

    def _run(wid):
        try:
            meshes[wid].connect(directory, rounds.peer_pairs(rnds))
            meshes[wid].set_rounds(rnds, rows[wid].numel(), boundaries)
            meshes[wid].execute_exchange(rows[wid])
            stats[wid] = meshes[wid].stats()
        except BaseException as e:          # noqa: BLE001
            errs.append(e)

    for wid in range(P):
        threads.append(threading.Thread(target=_run, args=(wid,)))
        threads[-1].start()
    for th in threads:
        th.join(timeout=60)
    alive = [th for th in threads if th.is_alive()]
    for m in meshes:
        m.close()
    assert not alive, "p2p exchange deadlocked"
    assert not errs, errs
    return rows, stats


@pytest.mark.parametrize("name,P", [("ring", 3), ("tree", 4),
                                    ("butterfly", 4)])
@pytest.mark.parametrize("bucketed", [False, True])
def test_mesh_rows_equal_the_centralized_mailbox(name, P, bucketed):
    """Every worker's row ends bitwise equal to row 0 of the centralized
    ``execute_rounds`` over the same inputs, monolithic or bucketed."""
    n = 999 + (-999) % P
    rng = np.random.RandomState(P)
    data = [torch.from_numpy(rng.randn(n)) for _ in range(P)]
    rnds = schedules.get(name).rounds(P, n * 8.0)
    cuts = [0, 250, 600, n] if bucketed else None
    mailbox = torch.zeros(P + 1, n, dtype=torch.float64)
    for i in range(P):
        mailbox[i] = data[i]
    rounds.execute_rounds(mailbox, n, rnds, boundaries=cuts)
    rows, stats = _mesh_exchange([d.clone() for d in data], rnds, cuts)
    for r in rows:
        assert torch.equal(r, mailbox[0])
    want = peer.predicted_link_bytes(rnds, n, cuts)
    for (i, j), b in want.items():
        assert stats[i]["peer_links"][str(j)]["wire_bytes"] == b
        assert stats[j]["peer_links"][str(i)]["wire_bytes"] == b


def test_mesh_streams_rows_past_the_socket_buffers():
    """Both sides send full-row segments to each other at once, 4x larger
    than SO_SNDBUF: the select-driven engine completes without helper
    threads or deadlock."""
    probe = socket.socket()
    sndbuf = probe.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF)
    probe.close()
    n = (4 * sndbuf) // 8 + 1
    rnds = schedules.get("butterfly").rounds(2, n * 8.0)
    rows = [torch.arange(n, dtype=torch.float64),
            2.0 * torch.arange(n, dtype=torch.float64)]
    want = rows[0] + rows[1]
    rows, _ = _mesh_exchange(rows, rnds)
    assert torch.equal(rows[0], want) and torch.equal(rows[1], want)


# ---------------------------------------------------------------------------
# localhost runs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo,P,schedule", [
    ("sync_easgd", 2, "tree"),
    ("sync_easgd", 3, "ring"),             # non-power-of-two ring
    ("sync_sgd", 4, "butterfly"),
])
def test_p2p_thread_master_triangle_bitwise_and_reference(algo, P,
                                                          schedule):
    """thread ↔ tcp master ↔ tcp p2p under deterministic admission: the
    same bits, which are also the reference's p2p run's."""
    thread = _plane_run(algo, P, None, schedule, transport="thread")
    master = _plane_run(algo, P, "master", schedule)
    p2p = _plane_run(algo, P, "p2p", schedule)
    ref = ref_ps.run_ps(ref_ps.NUMPY_MLP, REF_CFG,
                        _cfg(ref_ps, algo, P, "p2p", schedule, 48))
    assert (thread.total_iters == master.total_iters == p2p.total_iters
            == ref.total_iters == 48)
    assert torch.equal(thread.center, master.center)
    assert torch.equal(thread.center, p2p.center)
    assert torch.equal(thread.workers, p2p.workers)
    np.testing.assert_array_equal(p2p.center.numpy(), ref.center)
    np.testing.assert_array_equal(p2p.workers.numpy(), ref.workers)
    assert p2p.schedule == ref.schedule == f"{schedule}+p2p"


@pytest.mark.parametrize("schedule,P", [
    ("ring", 2), ("ring", 4), ("butterfly", 2), ("butterfly", 4),
])
def test_p2p_per_link_bytes_match_prediction(schedule, P):
    """Each worker pair's counter = exchanges × Σ (header + span bytes)
    over its messages: every SEGMENT frame counted, nothing else."""
    iters = 24
    res = _plane_run("sync_easgd", P, "p2p", schedule, iters=iters)
    n = res.center.numel()
    padded = n + (-n) % P
    exchanges = -(-iters // P)
    per_exchange = peer.predicted_link_bytes(
        schedules.get(schedule).rounds(P, n * 8), padded)
    want = {f"{i}-{j}": exchanges * b for (i, j), b in per_exchange.items()}
    assert res.counters["peer_link_bytes"] == want
    assert res.counters["sync_rounds"] == exchanges * len(
        schedules.get(schedule).rounds(P, n * 8))


def test_p2p_master_link_bytes_collapse_4x():
    """Ring at P = 4: ≥ 4x fewer bytes through the master's links on the
    p2p plane than on the master plane, at the same bits; each ring link
    carries 2(P−1) chunks of padded/P elements an exchange."""
    master = _plane_run("sync_easgd", 4, "master", "ring", iters=64)
    p2p = _plane_run("sync_easgd", 4, "p2p", "ring", iters=64)
    assert torch.equal(master.center, p2p.center)
    assert torch.equal(master.workers, p2p.workers)
    b_master = master.counters["master_link_bytes"]
    b_p2p = p2p.counters["master_link_bytes"]
    assert b_master >= 4 * b_p2p, (b_master, b_p2p)
    n, P = p2p.center.numel(), 4
    padded = n + (-n) % P
    per_link = (64 // P) * 2 * (P - 1) * (padded // P * 8 + wire.HEADER_SIZE)
    assert all(b == per_link
               for b in p2p.counters["peer_link_bytes"].values())


@pytest.mark.parametrize("algo", ["sync_easgd", "sync_sgd"])
@pytest.mark.parametrize("overlap", [True, False])
def test_bucketed_overlap_on_and_off_bitwise_to_monolithic(algo, overlap):
    mono = _plane_run(algo, 3, None, "ring", iters=24, transport="thread")
    res = _plane_run(algo, 3, "p2p", "ring", iters=24, bucket_bytes=4096,
                     overlap=overlap)
    assert torch.equal(mono.center, res.center)
    assert torch.equal(mono.workers, res.workers)
    assert res.counters["n_buckets"] > 1
    assert sum(res.counters["bucket_send_bytes"]) > 0
    if not overlap:
        # the no-overlap baseline waits out the whole wire
        assert res.counters["exposed_s"] >= 0.5 * res.counters["comm_s"]


def test_p2p_emulated_wire_changes_clock_not_math():
    slow = costmodel.Network("tiny-emu", 1e-3, 1e-9)
    a = _plane_run("sync_easgd", 2, "p2p", "ring", iters=40)
    b = _plane_run("sync_easgd", 2, "p2p", "ring", iters=40,
                   emulate_net=slow)
    assert torch.equal(a.center, b.center)
    assert b.total_time_s > 20 * 2 * 1e-3   # 2 paced rounds × 20 exchanges


def test_p2p_sign_ef_cuts_peer_bytes_and_reports_exactly():
    """1-bit SEGMENT payloads with per-(link, segment) error feedback cut
    the peer bytes ≥ 30x at matched loss; CENTER and the final WSTATE go
    raw (a sign-quantized center would have one magnitude)."""
    runs = {}
    for codec in ("none", "sign_ef"):
        runs[codec] = runtime.run_ps(
            problems.NUMPY_MLP, EASGDConfig(eta=0.1, rho=0.1, mu=0.9),
            _cfg(runtime, "sync_sgd", 2, "p2p", "butterfly", 240,
                 deterministic=False, wire_compression=codec,
                 eval_every_iters=120), device="cpu")
    b_none = runs["none"].counters["peer_wire_bytes"]
    b_sign = runs["sign_ef"].counters["peer_wire_bytes"]
    assert b_none >= 30 * b_sign, (b_none, b_sign)
    assert (runs["sign_ef"].final_metric
            <= runs["none"].final_metric + 0.10)
    res = runs["sign_ef"]
    assert len(torch.unique(res.center.abs())) > res.center.numel() // 2


def test_p2p_rejected_off_tcp_off_sync_and_master_routed():
    with pytest.raises(ValueError, match="sync_plane"):
        runtime.PSConfig(algorithm="sync_easgd", transport="thread",
                         sync_plane="p2p")
    with pytest.raises(ValueError, match="sync_plane"):
        runtime.PSConfig(algorithm="async_easgd", transport="tcp",
                         sync_plane="p2p")
    with pytest.raises(ValueError, match="master plane"):
        _plane_run("sync_easgd", 2, "p2p", "round_robin", iters=8)
