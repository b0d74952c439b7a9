"""Quickstart on the port: train a small gemma3-family LM with multi-pod
Sync EASGD on one device (``repro_torch.runtime.train``), then decode
greedily from its center weights. The port of examples/quickstart.py.

    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
    PYTHONPATH=src python examples/quickstart_torch.py      # on the card
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.core.easgd import EASGDConfig  # noqa: E402
from repro_torch.core.elastic import ElasticConfig  # noqa: E402
from repro_torch.data.pipeline import ShardedPipeline  # noqa: E402
from repro_torch.data.synthetic import SyntheticLMStream  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.runtime.train import build_train_step  # noqa: E402
from repro_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                                                   "cpu")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n_pods = 2
    cfg = configs.get("gemma3-4b").reduced
    ecfg = ElasticConfig(easgd=EASGDConfig(eta=0.15, rho=0.02, mu=0.9))
    B, S = 16, 32
    build = build_train_step(cfg, ecfg, n_pods=n_pods,
                             per_pod_batch=B // n_pods, seq=S, device=dev)
    state = build.init_state()

    pipe = ShardedPipeline(
        lambda shard, n: SyntheticLMStream(cfg.vocab_size, S, B // n_pods,
                                           seed=3, shard=shard, n_shards=n),
        n_pods=n_pods).start()
    print(f"training {args.steps} steps of Sync EASGD ({n_pods} pods × "
          f"{B // n_pods} seqs × {S} tokens) on {dev}…")
    try:
        for step in range(args.steps):
            state, metrics = build.step(state, pipe.next())
            if step % 8 == 0:
                print(f"  step {step:3d}  loss {float(metrics['loss']):.4f} "
                      f"acc {float(metrics['accuracy']):.3f}")
    finally:
        pipe.stop()
    print(f"final loss {float(metrics['loss']):.4f}")

    # decode a few tokens from the CENTER weights (the durable consensus)
    with torch.inference_mode():
        params = tfm.cast_for_serving(cfg, tfm.unflatten(state.center, cfg))
        caches = tfm.init_caches(cfg, 1, max_len=16, device=dev)
        tok = torch.zeros((1, 1), dtype=torch.int64, device=dev)
        out = []
        for t in range(8):
            logits, caches = tfm.decode_step(
                cfg, params, tok, caches,
                torch.tensor([t], dtype=torch.int64, device=dev))
            tok = torch.argmax(logits, dim=-1)[:, None]
            out.append(int(tok[0, 0]))
    print("greedy decode from center weights:", out)


if __name__ == "__main__":
    main()
