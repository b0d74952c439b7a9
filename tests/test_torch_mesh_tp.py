"""The placement's branches on gloo worlds on the CPU, held against the
port's own un-meshed step (itself held against the reference by
tests/test_torch_train.py) and against whole-vocabulary plain versions.

A ``(pod 2, data 2, model 2)`` world of 8 ranks runs reduced gemma3-4b at
f32 compute, 2 steps per case, every rank also running the un-meshed step
whole; the gathered meshed state must match it to 1e-5 (max abs; the
only difference is the order of the model- and data-parallel sums):

* ``kv_replicated``: 4 q heads, 1 kv head: ``model`` splits the q heads
  and not the kv heads, so each rank takes the kv head its q heads read;
* ``kv_per_head``: 6 q heads, 3 kv heads: a rank's q heads read kv heads
  unevenly (0, 0, 1), so it takes one kv head per q head;
* ``replicated_vocab_ff``: vocab 511 and d_ff 129, which ``model`` does
  not split: the embedding, the loss head and the FFN run whole;
* ``fsdp_microbatches``: FSDP over ``data`` (the block gathers and their
  reduce-scatter) with 2 microbatches and a partial mask;
* ``ring_bf16``: the ring schedule over the pod group with bf16
  compression (the second step's exchange carries nonzero deltas);
  ``tau2`` (the second step momentum-only); ``msgd``; ``unpacked`` (the
  per-tensor exchange).

A world of 4 runs ``launch.train --mode sync`` on its ``(pod 2, data 2,
model 1)`` mesh: 6 steps straight, then 4 steps that checkpoint (the
state gathered to whole tensors, written by rank 0) and a run that
resumes from them (each rank restores and keeps its block): the resumed
losses equal the straight run's, bit for bit.

Worlds of 2 run ``chip_smoke.py``'s phase 23 hold (``held_sums``, the
relative norm of the error in the params', momentum's and center's moves)
at bf16 compute on reduced gemma3-4b, meshed as ``model`` 2 and as
``pod`` 2 against the un-meshed steps: within ``HELD_TOL`` as they are,
and ten times over it with the model-parallel gradient's all-reduce, or
the pod sum, left out.

A world of 4 holds the vocab-parallel cross-entropy (a model group of 2)
against the whole vocabulary, forward and backward, with an argmax tied
across the two shards (the lower index wins, as ``jnp.argmax``); the
ring's rounds over process groups of 2 and 4 against ``all_reduce``;
and a schedule other than psum / ring on a group raises.
"""
import math

import pytest

import chip_smoke
from test_torch_mesh_worlds import World

EASGD = dict(eta=0.05, rho=0.02, mu=0.9)
CASES = (
    {"name": "kv_replicated", "cfg": {"n_kv_heads": 1}},
    {"name": "kv_per_head", "cfg": {"n_heads": 6, "n_kv_heads": 3}},
    {"name": "replicated_vocab_ff", "cfg": {"vocab_size": 511,
                                            "d_ff": 129}},
    {"name": "fsdp_microbatches", "cfg": {"fsdp": True},
     "microbatches": 2},
    {"name": "ring_bf16", "ecfg": {"schedule": "ring",
                                   "compression": "bf16"}},
    {"name": "tau2", "tau": 2},
    {"name": "msgd", "ecfg": {"mode": "msgd"}},
    {"name": "unpacked", "ecfg": {"packed": False, "overlap": False}},
)
TOL = 1e-5
FAULTS = (None, "copy_in", "pod_sum")


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("tp_worlds")
    started = {"variants": World(8, "variants_world",
                                 {"cases": CASES, "easgd": EASGD}, out),
               "kernels": World(4, "kernels_world", {}, out),
               "launcher": World(4, "launcher_world",
                                 {"ckpt_dir": str(out / "ckpt")}, out)}
    for fault in FAULTS:
        (out / f"hold-{fault}").mkdir()
        started[f"hold-{fault}"] = World(2, "hold_world", {"fault": fault},
                                         out / f"hold-{fault}")
    yield started
    for w in started.values():
        w.close()


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_mesh_branch_matches_unmeshed_step(worlds, case):
    outs = worlds["variants"].results()
    got = outs[0][case]
    assert got["shapes"]
    for k, v in got["err"].items():
        assert v <= TOL, (case, k, v)
    # each rank holds one pod's row of its shard
    assert all(o[case]["local"][0] == 1 for o in outs)


def test_vocab_parallel_cross_entropy(worlds):
    for o in worlds["kernels"].results():
        assert o["pred"] and o["pred0"] == 5
        assert o["loss"] <= 1e-5 and o["dh"] <= 1e-5 and o["dw"] <= 1e-5, o


@pytest.mark.parametrize("name", ["ring2", "ring4"])
def test_ring_rounds_over_a_group(worlds, name):
    for o in worlds["kernels"].results():
        assert o[name] <= 1e-5, o[name]


def test_other_schedules_raise_on_a_group(worlds):
    for o in worlds["kernels"].results():
        assert o["butterfly"] is not None and "butterfly" in o["butterfly"]


def test_launcher_on_a_mesh_resumes_bitwise(worlds):
    outs = worlds["launcher"].results()
    for o in outs:
        assert len(o["straight"]) == 6 and len(o["first"]) == 4
        assert o["first"] == o["straight"][:4]
        assert o["resumed"] == o["straight"][4:]


@pytest.mark.parametrize("fault", FAULTS)
def test_chip_hold_passes_and_catches_faults(worlds, fault):
    outs = worlds[f"hold-{fault}"].results()
    rel = {name: {k: math.sqrt(sum(o[name][k][0] for o in outs)
                               / sum(o[name][k][1] for o in outs))
                  for k in chip_smoke.HELD}
           for name, _ in chip_smoke.MESH_WORLDS}
    tol = chip_smoke.HELD_TOL
    if fault is None:
        assert all(v <= tol[k] for r in rel.values()
                   for k, v in r.items()), rel
        assert all(v == 0 for v in rel["pod 2"].values()), rel
    elif fault == "copy_in":
        assert all(rel["model 2"][k] > 10 * tol[k]
                   for k in chip_smoke.HELD), rel
    else:
        assert rel["pod 2"]["center"] > 10 * tol["center"], rel
