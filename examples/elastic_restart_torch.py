"""Fault-tolerance demo on the port: checkpoint / restart and an elastic
pod rescale. The port of examples/elastic_restart.py.

Trains Sync EASGD with 2 pods (``repro_torch.runtime.train``), "crashes",
restores from the checkpoint, rescales to 3 pods (the joiner seeds from
the center weight: EASGD's own semantics) and trains on. Loss continuity
is asserted.

    PYTHONPATH=src python examples/elastic_restart_torch.py --device cpu
    PYTHONPATH=src python examples/elastic_restart_torch.py      # the card
"""
import argparse
import shutil
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core.easgd import EASGDConfig  # noqa: E402
from repro_torch.core.elastic import ElasticConfig  # noqa: E402
from repro_torch.data.pipeline import ShardedPipeline  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMStream  # noqa: E402
from repro_torch.ft import rescale_pods  # noqa: E402
from repro_torch.runtime.train import build_train_step  # noqa: E402
from repro_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                                                   "cpu")
    ap.add_argument("--steps", type=int, default=12,
                    help="steps before the crash, and again after it")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = configs.get("recurrentgemma-2b").reduced
    ecfg = ElasticConfig(easgd=EASGDConfig(eta=0.05, rho=0.02, mu=0.9),
                         packed=False)
    B, S = 4, 32

    def build(n_pods):
        return build_train_step(cfg, ecfg, n_pods=n_pods, per_pod_batch=B,
                                seq=S, device=dev)

    def make_pipe(n_pods, start=0):
        return ShardedPipeline(
            lambda shard, n: SyntheticLMStream(cfg.vocab_size, S, B, seed=5,
                                               shard=shard, n_shards=n),
            n_pods=n_pods, start_step=start)

    def train(step, state, pipe):
        losses = []
        for _ in range(args.steps):
            state, metrics = step(state, pipe.next())
            losses.append(float(metrics["loss"]))
        return state, losses

    two = build(2)
    state, losses = train(two.step, two.init_state(), make_pipe(2))
    ckpt_dir = tempfile.mkdtemp(prefix="elastic_demo_")
    try:
        ckpt = CheckpointManager(ckpt_dir)
        ckpt.save(args.steps, state, extra={"data_step": args.steps})
        print(f"phase 1 (2 pods, {dev}): loss {losses[0]:.3f} -> "
              f"{losses[-1]:.3f}; checkpointed and 'crashed'")
        del state

        # restart: restore, then grow elastically to 3 pods
        restored, meta = ckpt.restore(two.init_state())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    state2 = rescale_pods(restored, 3)
    assert torch.equal(state2.params[2],
                       restored.center.to(state2.params.dtype)), \
        "the joiner is not the center weight"
    print("restored at step", meta["extra"]["data_step"],
          "and grew to 3 pods (joiner seeded from the center weight)")

    three = build(3)
    state2, losses2 = train(three.step, state2,
                            make_pipe(3, start=meta["extra"]["data_step"]))
    print(f"phase 2 (3 pods): loss {losses2[0]:.3f} -> {losses2[-1]:.3f}")
    assert losses2[0] < losses[0] + 0.5, "loss continuity broken by restart"
    print("loss continuity across crash+rescale: OK")
    return {"before": losses, "after": losses2}


if __name__ == "__main__":
    main()
