"""The port's multi-pod training step (``repro_torch.runtime.train``), its
data pipeline, checkpoints and launcher against the reference's, on
reduced gemma3-4b.

The reference's ``build_train_step`` runs with its pods local on one CPU
device (mesh ``(data=1, model=1)``, ``n_pods=2``) in a subprocess, under
the no-FMA pin its own bitwise tests use (``--xla_cpu_max_isa=SSE4_2``):
with XLA's default FMA contraction the center's update ``C + ηρP(M − C)``
rounds differently in most elements, and the center moves too little per
step for that to stay under any useful bound. The subprocess writes its
initial and final states as checkpoints in the reference's layout; the
port restores the initial one (so a reference checkpoint restoring into
the port is tested on the way) and takes the same steps on the same
batches.

The cases: f32 compute, psum, two microbatches; the config's bf16
compute, ring, bf16 compression; f32, ring, sign_ef compression, τ = 3
(the exchange of step 3 follows two momentum-only steps); f32 msgd with two
microbatches; reduced mamba2-780m in f32, psum (its intra-chunk term
through the SSD plain version). Four steps each.

Tolerances, by the scale-free ‖port − ref‖ / ‖ref − init‖ for the state
(the center's init is the params' init; the momentum's and the error
feedback's is 0):

* f32 compute: loss 1e-5 relative, params, momentum, center and error
  feedback 1e-4 (measured 1.5e-7 on the loss, 1.5e-6 / 6.6e-7 on params
  and momentum, 9e-9 on the sign_ef center and 1.8e-6 on its error
  feedback);
* the config's bf16 compute: loss 1e-3 relative and the params to the
  reference's own 5e-3 absolute (tests/test_distributed.py), since bf16
  rounds at other places in the two frameworks.

The update on its own, at n_pods 1–3 and every composition, is held by
tests/test_torch_elastic.py; the gradient is the one
tests/test_torch_lm.py holds.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as RefCheckpointManager
from repro.core import elastic as ref_elastic
from repro.core.easgd import EASGDConfig as RefEASGD
from repro.data import pipeline as ref_pipeline
from repro.data import synthetic as ref_synthetic
from repro.models import transformer as ref_tfm
from repro.models.common import init_params as ref_init
from repro import configs as ref_configs
from repro_torch import configs, kernels
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import elastic
from repro_torch.core.easgd import EASGDConfig
from repro_torch.data import pipeline, synthetic
from repro_torch.launch import train as launcher
from repro_torch.runtime.train import build_train_step, make_batch_defs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
ARCH = "gemma3-4b"
STEPS, PODS, BATCH, SEQ = 4, 2, 4, 16
EASGD = dict(eta=0.05, rho=0.02, mu=0.9)
CASES = {
    "f32": dict(compute="float32", schedule="psum", compression="none",
                microbatches=2, tau=1, mode="sync_easgd"),
    "bf16": dict(compute="bfloat16", schedule="ring", compression="bf16",
                 microbatches=1, tau=1, mode="sync_easgd"),
    "sign_ef": dict(compute="float32", schedule="ring", compression="sign_ef",
                    microbatches=1, tau=3, mode="sync_easgd"),
    "msgd": dict(compute="float32", schedule="psum", compression="none",
                 microbatches=2, tau=1, mode="msgd"),
    "mamba2": dict(compute="float32", schedule="psum", compression="none",
                   microbatches=1, tau=1, mode="sync_easgd",
                   arch="mamba2-780m"),
}

_REF_SCRIPT = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from repro import configs
from repro.checkpoint import CheckpointManager
from repro.core.easgd import EASGDConfig
from repro.core.elastic import ElasticConfig
from repro.runtime.train import build_train_step
from repro.utils.jaxcompat import auto_mesh
spec = json.loads(sys.argv[1])
batches = np.load(sys.argv[2])
out = {}
mesh = auto_mesh((1, 1), ("data", "model"))
for name, case in spec["cases"].items():
    cfg = dataclasses.replace(configs.get(case.get("arch",
                                                   spec["arch"])).reduced,
                              compute_dtype=getattr(jnp, case["compute"]))
    ecfg = ElasticConfig(easgd=EASGDConfig(**spec["easgd"], tau=case["tau"]),
                         schedule=case["schedule"], mode=case["mode"],
                         compression=case["compression"])
    build = build_train_step(cfg, ecfg, mesh, n_pods=spec["pods"],
                             per_pod_batch=spec["batch"], seq=spec["seq"],
                             microbatches=case["microbatches"])
    state = build.init_state()
    ckpt = CheckpointManager(f"{spec['dir']}/{name}", keep=10)
    ckpt.save(0, state)
    losses = []
    for s in range(spec["steps"]):
        batch = {k: jnp.asarray(batches[f"{k}_{s}"])
                 for k in ("tokens", "targets", "mask")}
        state, metrics = build.step(state, batch)
        losses.append({k: float(v) for k, v in metrics.items()})
    ckpt.save(spec["steps"], state)
    out[name] = losses
json.dump(out, open(f"{spec['dir']}/losses.json", "w"))
print("REF-OK")
"""


def _batches():
    rng = np.random.RandomState(0)
    out = {}
    for s in range(STEPS):
        tok = rng.randint(0, 512, size=(PODS, BATCH, SEQ + 1))
        out[f"tokens_{s}"] = tok[..., :-1].astype(np.int32)
        out[f"targets_{s}"] = tok[..., 1:].astype(np.int32)
        out[f"mask_{s}"] = (rng.rand(PODS, BATCH, SEQ) > 0.1).astype(
            np.float32)
    return out


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's steps for every case: its checkpoints (init and
    final state) and its per-step metrics."""
    tmp = tmp_path_factory.mktemp("ref_train")
    np.savez(tmp / "batches.npz", **_batches())
    spec = {"arch": ARCH, "cases": CASES, "easgd": EASGD, "pods": PODS,
            "batch": BATCH, "seq": SEQ, "steps": STEPS, "dir": str(tmp)}
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_cpu_max_isa=SSE4_2")
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, json.dumps(spec),
         str(tmp / "batches.npz")], env=env, capture_output=True, text=True,
        timeout=900)
    assert proc.returncode == 0 and "REF-OK" in proc.stdout, \
        proc.stderr[-4000:]
    with open(tmp / "losses.json") as f:
        return tmp, json.load(f)


def _port_build(case, **kw):
    c = CASES[case]
    cfg = dataclasses.replace(configs.get(c.get("arch", ARCH)).reduced,
                              compute_dtype=getattr(torch, c["compute"]))
    ecfg = elastic.ElasticConfig(easgd=EASGDConfig(**EASGD, tau=c["tau"]),
                                 schedule=c["schedule"], mode=c["mode"],
                                 compression=c["compression"], **kw)
    return build_train_step(cfg, ecfg, n_pods=PODS, per_pod_batch=BATCH,
                            seq=SEQ, microbatches=c["microbatches"],
                            device="cpu")


def _run_port(build, state, steps=STEPS):
    batches = _batches()
    losses = []
    for s in range(steps):
        state, metrics = build.step(state, {
            k: batches[f"{k}_{s}"] for k in ("tokens", "targets", "mask")})
        losses.append({k: float(v) for k, v in metrics.items()})
    return state, losses


def _rel(port, ref, init):
    return float((port.double() - ref.double()).norm()
                 / (ref.double() - init.double()).norm())


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_reference(reference, case):
    tmp, ref_losses = reference
    build = _port_build(case)
    ckpt = CheckpointManager(str(tmp / case))
    init, _ = ckpt.restore(build.init_state(), step=0)
    want, _ = ckpt.restore(build.init_state(), step=STEPS)
    assert want.step == STEPS
    start = init.params.clone()
    kernels.reset_launch_counts()
    got, losses = _run_port(build, init)
    assert all(v == 0 for v in kernels.launch_counts().values())
    assert got.step == STEPS
    for mine, ref in zip(losses, ref_losses[case]):
        assert set(mine) == set(ref)
        limit = 1e-3 if case == "bf16" else 1e-5
        assert abs(mine["loss"] - ref["loss"]) <= limit * abs(ref["loss"])
        assert mine["tokens"] == ref["tokens"]
    if case == "bf16":
        assert float((got.params - want.params).abs().max()) <= 5e-3
        assert float((got.center - want.center).abs().max()) <= 5e-3
        assert got.ef_error is not None
        return
    zero = torch.zeros_like(start)
    assert _rel(got.params, want.params, start) <= 1e-4
    assert _rel(got.momentum, want.momentum, zero) <= 1e-4
    if case == "msgd":
        assert got.center is None and got.ef_error is None
        return
    assert _rel(got.center, want.center, start[0]) <= 1e-4
    if case == "sign_ef":
        assert _rel(got.ef_error, want.ef_error, zero) <= 1e-4


def test_overlap_on_and_off_give_the_same_bits(reference):
    tmp, _ = reference
    runs = []
    for overlap in (True, False):
        build = _port_build("bf16", overlap=overlap)
        init, _ = CheckpointManager(str(tmp / "bf16")).restore(
            build.init_state(), step=0)
        runs.append(_run_port(build, init)[0])
    for name in ("params", "momentum", "center", "ef_error"):
        assert torch.equal(getattr(runs[0], name), getattr(runs[1], name))


def test_port_checkpoint_restores_into_the_reference(reference, tmp_path):
    """The reverse direction: the port's state after its steps, written by
    the port, read by the reference's manager into its own template."""
    tmp, _ = reference
    build = _port_build("f32")
    init, _ = CheckpointManager(str(tmp / "f32")).restore(
        build.init_state(), step=0)
    got, _ = _run_port(build, init, steps=1)
    CheckpointManager(str(tmp_path)).save(1, got, extra={"data_step": 2})
    cfg = ref_configs.get(ARCH).reduced
    ecfg = ref_elastic.ElasticConfig(easgd=RefEASGD(**EASGD))
    template = ref_elastic.init(
        ref_init(ref_tfm.model_defs(cfg), jax.random.PRNGKey(1),
                 cfg.param_dtype), ecfg, PODS)
    ref_state, meta = RefCheckpointManager(str(tmp_path)).restore(template)
    assert meta["extra"] == {"data_step": 2} and int(ref_state.step) == 1
    back = elastic.state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                         ref_state),
                                  device="cpu")
    for name in ("params", "momentum", "center"):
        assert torch.equal(getattr(back, name), getattr(got, name))


def test_restore_checks_the_layout(reference, tmp_path):
    tmp, _ = reference
    state = _port_build("bf16").init_state()      # carries error feedback
    with pytest.raises(ValueError):
        CheckpointManager(str(tmp / "f32")).restore(state, step=0)


def test_checkpoint_manager_keeps_n_and_saves_async(tmp_path):
    build = _port_build("f32")
    state = build.init_state()
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3):
        saved = state.params.clone()
        ckpt.save_async(s, state, extra={"data_step": s + 1})
        state.params.add_(1.0)           # the snapshot was taken already
    ckpt.wait()
    assert ckpt.all_steps() == [2, 3] and ckpt.latest_step() == 3
    back, meta = ckpt.restore(build.init_state())
    assert meta["extra"] == {"data_step": 4}
    assert torch.equal(back.params, saved)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 3)])
def test_synthetic_lm_stream_matches_reference(shard, n_shards):
    kw = dict(vocab_size=512, seq=24, batch=3, seed=13, shard=shard,
              n_shards=n_shards)
    port, ref = (synthetic.SyntheticLMStream(**kw),
                 ref_synthetic.SyntheticLMStream(**kw))
    for step in (0, 1, 17):
        a, b = port.batch_at(step), ref.batch_at(step)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_sharded_pipeline_matches_reference():
    def make(mod_pipe, mod_syn):
        return mod_pipe.ShardedPipeline(
            lambda shard, n: mod_syn.SyntheticLMStream(
                512, 16, 2, seed=13, shard=shard, n_shards=n),
            n_pods=2).start()

    port = make(pipeline, synthetic)
    ref = make(ref_pipeline, ref_synthetic)
    try:
        seq = []
        for p in (port, ref):
            got = [p.next() for _ in range(3)]
            p.restore(1)                      # rewind: exact resume
            got += [p.next() for _ in range(2)]
            p.rescale(3)                      # elastic pod count change
            got.append(p.next())
            seq.append(got)
        for a, b in zip(*seq):
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
        assert seq[0][-1]["tokens"].shape == (3, 2, 16)
    finally:
        port.stop()
        ref.stop()


def test_make_batch_defs_matches_reference():
    from repro.runtime import train as ref_train
    cfg = ref_configs.get(ARCH).reduced
    ref = ref_train.make_batch_defs(cfg, 2, 4, 16)
    port = make_batch_defs(configs.get(ARCH).reduced, 2, 4, 16)
    assert sorted(port) == sorted(ref)
    for k in ref:
        assert port[k][0] == ref[k].shape
        assert str(port[k][1]).split(".")[-1] == str(ref[k].dtype)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(capsys, *extra):
    losses = launcher.main(["--arch", ARCH, "--reduced", "--n-pods", "2",
                            "--batch", "8", "--seq", "32", "--device", "cpu",
                            "--log-every", "1", *extra])
    return losses, capsys.readouterr().out


def test_launcher_sync_mode_prints_the_reference_lines(capsys):
    losses, out = _launch(capsys, "--steps", "6")
    lines = out.splitlines()
    assert lines[0] == ("exchange: schedule=psum compression=none "
                        "overlap=True n_pods=2")
    steps = [ln for ln in lines if ln.startswith("step ")]
    assert len(steps) == 6 and len(losses) == 6
    assert all(re.fullmatch(r"step +\d+ loss \d+\.\d{4} acc \d\.\d{3} "
                            r"\(\d+\.\d+s\)", ln) for ln in steps)
    assert re.fullmatch(r"loss \d+\.\d{4} -> \d+\.\d{4} \((NOT )?improved\)",
                        lines[-2])
    assert lines[-1].startswith("launches={")
    assert all(np.isfinite(losses))


def test_launcher_resume_reproduces_the_uninterrupted_run(capsys, tmp_path):
    """Resuming from step k reproduces the uninterrupted run bit for bit
    on the CPU: the checkpoint holds the whole state, the pipeline's cursor
    is the step."""
    full, _ = _launch(capsys, "--steps", "4", "--ckpt-dir",
                      str(tmp_path / "a"), "--tau", "2")
    first, _ = _launch(capsys, "--steps", "2", "--ckpt-dir",
                       str(tmp_path / "b"), "--tau", "2")
    rest, out = _launch(capsys, "--steps", "4", "--ckpt-dir",
                        str(tmp_path / "b"), "--tau", "2")
    assert "resumed from step 2" in out
    assert first + rest == full
    a = np.load(tmp_path / "a" / f"step_{3:012d}" / "arrays.npz")
    b = np.load(tmp_path / "b" / f"step_{3:012d}" / "arrays.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k])


def test_heartbeat_is_never_read_half_written(tmp_path):
    """P2: a reader polling a heartbeat that beats every millisecond never
    sees a live process as dead: each beat replaces the file whole."""
    import os
    import time

    from repro_torch.ft import Watchdog
    hb = str(tmp_path / "hb")
    wd = Watchdog(heartbeat_path=hb, interval_s=0.001,
                  install_signals=False).start_heartbeat()
    try:
        deadline = time.time() + 10
        while not os.path.exists(hb) and time.time() < deadline:
            time.sleep(0.001)
        reads = dead = 0
        end = time.time() + 1.0
        while time.time() < end:
            reads += 1
            dead += not Watchdog.is_alive(hb)
        assert reads > 100 and dead == 0, f"{dead} of {reads} reads dead"
    finally:
        wd.close()
        wd._hb_thread.join(timeout=10)
    assert [p.name for p in tmp_path.iterdir()] == ["hb"]


def test_watchdog_flags_a_signal_and_beats(tmp_path):
    """The port's watchdog behaves as the reference's: a heartbeat file a
    supervisor can read, the stop flag on SIGTERM, the previous handlers
    restored on close."""
    import signal
    import time

    from repro.ft import Watchdog as RefWatchdog
    from repro_torch.ft import Watchdog
    for cls in (Watchdog, RefWatchdog):
        hb = tmp_path / f"hb_{cls.__module__}"
        before = signal.getsignal(signal.SIGTERM)
        wd = cls(heartbeat_path=str(hb), interval_s=0.05).start_heartbeat()
        deadline = time.time() + 10
        # the loop's own reading is the one held: the reference's beat
        # truncates the file before it writes the time (R4), so a second
        # read could land in that gap
        alive = False
        while not alive and time.time() < deadline:
            alive = cls.is_alive(str(hb))
            if not alive:
                time.sleep(0.01)
        assert alive and not wd.should_stop.is_set()
        wd._on_signal(signal.SIGTERM, None)
        assert wd.should_stop.is_set()
        wd.close()
        assert signal.getsignal(signal.SIGTERM) == before
        assert not cls.is_alive(str(tmp_path / "missing"))
