"""The MoE and MLA layer kinds on the meshed training step, on a gloo
world of 4 ranks on the CPU (a ``(data 2, model 2)`` mesh), against the
reference's unsharded steps at f32 (tests/torch_mesh_kinds_parity.py).

* deepseek-v2-236b (reduced, 8 experts top-2, 2 shared): the experts 4 a
  rank over ``data`` with the dispatch and combine all-to-alls (4 groups
  of 16 tokens, 2 a rank), ``expert_ff`` and the shared experts' ``ff``
  over ``model``, MLA's 4 heads 2 a rank;
* grok-1-314b (reduced, 4 experts top-2): the experts 2 a rank;
* grok-1-314b with ``moe_ep=False`` and FSDP: the experts whole on every
  rank of ``data`` (their ``embed`` dim gathered per layer);
* deepseek-v2-236b with ``dispatch_groups=1``: one group, which does not
  split over ``data``, so each rank routes the whole microbatch (its
  tokens all-gathered) and keeps its rows of the combine.

Each also holds the ``aux`` metric (the pod's, the sum of the ranks'
shares) against the reference's. The limits are a few times what these
cases read; grok's attention, without qk-norm, is the worst conditioned
(its f32 moves ~1e-3 after two steps, where one step reads ~1e-5).
Planted faults in the same world, each at least ten times its limit: the
dispatch all-to-all skipped (each rank keeps its own buffer), a local aux
loss (the mean of the ranks' own aux losses: the ``aux`` limit), and the
latents' gradient left unsummed over ``model`` (``copy_in``'s backward
the identity).
"""
import pytest

import torch_mesh_kinds_parity as mk
from test_torch_mesh_worlds import World

CASES = (
    {"name": "deepseek", "arch": "deepseek-v2-236b", "compute": "float32",
     "ref": "deepseek"},
    {"name": "deepseek_all_to_all", "arch": "deepseek-v2-236b",
     "compute": "float32", "ref": "deepseek", "fault": "all_to_all"},
    {"name": "deepseek_local_aux", "arch": "deepseek-v2-236b",
     "compute": "float32", "ref": "deepseek", "fault": "local_aux"},
    {"name": "deepseek_copy_in", "arch": "deepseek-v2-236b",
     "compute": "float32", "ref": "deepseek", "fault": "copy_in"},
    {"name": "grok", "arch": "grok-1-314b", "compute": "float32",
     "ref": "grok"},
    {"name": "grok_no_ep_fsdp", "arch": "grok-1-314b", "compute": "float32",
     "ref": "grok", "cfg": {"moe_ep": False, "fsdp": True}},
    {"name": "deepseek_groups1", "arch": "deepseek-v2-236b",
     "compute": "float32", "ref": "deepseek_groups1",
     "cfg": {"moe": {"dispatch_groups": 1}}},
)
REFS = {c["name"]: c for c in CASES
        if c["name"] in ("deepseek", "grok", "deepseek_groups1")}
# a few times the readings: deepseek params 2.3e-6, momentum 2.1e-5,
# center 1.8e-4, loss 1.5e-7, aux 1.1e-7; with one group 1.3e-6, 1.3e-5,
# 2.1e-4, 0, 1.1e-7; grok (both layouts) 9.9e-4, 8.6e-4, 7.4e-5, 6.1e-6,
# 1.2e-7. The faults read 0.81 (all_to_all) and 1.0 (copy_in) in the
# momentum, 0.12 (local_aux) in the aux.
F32 = {"params": 1e-5, "momentum": 1e-4, "center": 1e-3, "loss": 1e-6,
       "aux": 1e-6}
GROK = {"params": 5e-3, "momentum": 5e-3, "center": 5e-4, "loss": 5e-5,
        "aux": 1e-6}
LIMITS = {"deepseek": F32, "deepseek_groups1": F32, "grok": GROK,
          "grok_no_ep_fsdp": GROK}
FAULT_OF = {"all_to_all": "momentum", "local_aux": "aux",
            "copy_in": "momentum"}
FAULTS = {c["name"]: c for c in CASES if "fault" in c}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    starts = {k: mk.ref_start(c) for k, c in REFS.items()}
    out = tmp_path_factory.mktemp("kinds_moe")
    world = World(4, "kinds_world", {
        "shape": (2, 2), "cases": CASES, "easgd": mk.EASGD,
        "steps": mk.STEPS, "batch": mk.BATCH, "seq": mk.SEQ,
        **mk.payload_of(starts)}, out)
    refs = {k: mk.ref_steps(c, starts[k]) for k, c in REFS.items()}
    yield {"refs": refs, "kinds": world}
    world.close()


@pytest.mark.parametrize("case", [c["name"] for c in CASES
                                  if "fault" not in c])
def test_mesh_moe_step_matches_reference(worlds, case):
    c = {x["name"]: x for x in CASES}[case]
    outs = worlds["kinds"].results()
    mk.hold(outs[0][case], worlds["refs"][c["ref"]], LIMITS[case])
    for o in outs[1:]:
        for a, b in zip(o[case]["leaves"], outs[0][case]["leaves"]):
            assert (a == b).all()


@pytest.mark.parametrize("case", sorted(FAULTS))
def test_mesh_moe_limit_rejects_planted_fault(worlds, case):
    c = FAULTS[case]
    got = worlds["kinds"].results()[0][case]
    mk.hold(got, worlds["refs"][c["ref"]], LIMITS[c["ref"]],
            fault=FAULT_OF[c["fault"]])
