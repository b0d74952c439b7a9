"""The SSM and RG-LRU layer kinds on the meshed training step, on a gloo
world of 4 ranks on the CPU (a ``(data 2, model 2)`` mesh), against the
reference's unsharded steps (tests/torch_mesh_kinds_parity.py: two packed steps
of one pod on one batch from the reference's initial state).

* mamba2-780m (reduced): ``model`` splits the 8 SSD heads 4 a rank and
  ``w_in``'s and the conv's mixed columns in blocks that are not a rank's
  heads (the block reads them whole); ``data`` splits the batch. At f32
  and at bf16 compute.
* mamba2-780m with one SSD head (head_dim 128), which ``model`` does not
  split: every rank runs the block whole, reading the conv, the norm and
  ``w_out`` (which the specs still split) through ``tp.gather_whole``.
* recurrentgemma-2b (reduced): the RG-LRU width 32 a rank, the gates'
  partial products reduce-scattered; its local-attention layer has one
  kv head (replicated over ``model``).

The limits are a few times what these cases read (``LIMITS``); at bf16
the meshed step reads what the un-meshed one does against the reference
(6.7e-2 and 6.9e-2 in the momentum). Two planted faults, each in the same
world: the gated norm's variance summed over ``model`` in the forward
only (``norm_sum``), and the RG-LRU gate partials all-reduced with the
identity backward (``gate_identity``); each must read at least ten times
the momentum's limit.

A world of 2 holds each new collective of ``models.tp`` inside a small
function, output and gradient, against the function computed whole, in
f64: ``all_to_all``, ``reduce_scatter``, ``model_sum`` and
``gather_whole``.
"""
import pytest

import torch_mesh_kinds_parity as mk
from test_torch_mesh_worlds import World

CASES = (
    {"name": "mamba2", "arch": "mamba2-780m", "compute": "float32",
     "ref": "mamba2"},
    {"name": "mamba2_norm_sum", "arch": "mamba2-780m",
     "compute": "float32", "ref": "mamba2", "fault": "norm_sum"},
    {"name": "recurrentgemma", "arch": "recurrentgemma-2b",
     "compute": "float32", "ref": "recurrentgemma"},
    {"name": "recurrentgemma_gate_identity", "arch": "recurrentgemma-2b",
     "compute": "float32", "ref": "recurrentgemma",
     "fault": "gate_identity"},
    {"name": "mamba2_bf16", "arch": "mamba2-780m", "compute": "bfloat16",
     "ref": "mamba2_bf16"},
    {"name": "mamba2_heads_whole", "arch": "mamba2-780m",
     "compute": "float32", "ref": "mamba2_heads_whole",
     "cfg": {"ssm": {"head_dim": 128}}},
)
REFS = {c["ref"]: c for c in CASES if "fault" not in c}
# a few times the readings: f32 mamba2 params 1.8e-7, momentum 3.8e-6,
# center 3.0e-4 (its f32 rounding beside a small move), loss 8.0e-8;
# recurrentgemma 3.3e-5, 2.1e-4, 2.1e-4, 4.6e-7 (the port's un-meshed
# step reads 1.7e-5, 1.8e-4, 2.0e-4 against the reference: its scan sums
# in another order); bf16 mamba2 2.3e-3, 6.7e-2, 4.2e-2, 2.6e-4 (the
# un-meshed step 2.1e-3, 6.9e-2, 3.7e-2, 2.8e-4); one whole head 1.4e-5,
# 3.2e-4, 2.3e-4, 0 (the un-meshed step reads 1.3e-5, 3.1e-4, 2.3e-4).
# The faults read 0.46
# (norm_sum) and 0.58 (gate_identity) in the momentum.
LIMITS = {
    "mamba2": {"params": 1e-6, "momentum": 2e-5, "center": 1e-3,
               "loss": 1e-6, "aux": 0.0},
    "recurrentgemma": {"params": 1e-4, "momentum": 1e-3, "center": 1e-3,
                       "loss": 5e-6, "aux": 0.0},
    "mamba2_bf16": {"params": 5e-3, "momentum": 0.15, "center": 0.1,
                    "loss": 1e-3, "aux": 0.0},
    "mamba2_heads_whole": {"params": 5e-5, "momentum": 1e-3,
                           "center": 1e-3, "loss": 1e-6, "aux": 0.0}}
FAULTS = {c["name"]: c for c in CASES if "fault" in c}
COLLECTIVE_TOL = 1e-12


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    starts = {k: mk.ref_start(c) for k, c in REFS.items()}
    out = tmp_path_factory.mktemp("kinds")
    started = {
        "kinds": World(4, "kinds_world", {
            "shape": (2, 2), "cases": CASES, "easgd": mk.EASGD,
            "steps": mk.STEPS, "batch": mk.BATCH, "seq": mk.SEQ,
            **mk.payload_of(starts)}, out),
        "collectives": World(2, "collectives_world", {}, out)}
    refs = {k: mk.ref_steps(c, starts[k]) for k, c in REFS.items()}
    yield {"refs": refs, **started}
    for w in started.values():
        w.close()


@pytest.mark.parametrize("case", [c["name"] for c in CASES
                                  if "fault" not in c])
def test_mesh_kind_step_matches_reference(worlds, case):
    outs = worlds["kinds"].results()
    mk.hold(outs[0][case], worlds["refs"][case], LIMITS[case])
    # every rank gathers the same state; its own block is smaller
    for o in outs[1:]:
        for a, b in zip(o[case]["leaves"], outs[0][case]["leaves"]):
            assert (a == b).all()
    assert all(o[case]["local"][1] < sum(x.size for x in worlds["refs"][
        case]["params"]) for o in outs)


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_mesh_kind_limit_rejects_planted_fault(worlds, case):
    c = FAULTS[case]
    got = worlds["kinds"].results()[0][case]
    mk.hold(got, worlds["refs"][c["ref"]], LIMITS[c["ref"]],
            fault="momentum")


@pytest.mark.parametrize("name", ["all_to_all", "reduce_scatter",
                                  "model_sum", "gather_whole"])
def test_collective_gradient_matches_unsharded(worlds, name):
    for out in worlds["collectives"].results():
        value, grad = out[name]
        assert value <= COLLECTIVE_TOL and grad <= COLLECTIVE_TOL, \
            (name, value, grad)
