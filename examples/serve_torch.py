"""Serve a model with batched requests through the port's continuous-
batching engine (``repro_torch.runtime.serve.BatchingEngine``), the port
of examples/serve.py with its flags, plus ``--device`` and ``--full``.

    PYTHONPATH=src python examples/serve_torch.py --arch mamba2-780m \
        --device cpu
    PYTHONPATH=src python examples/serve_torch.py --arch gemma3-4b --full

The weights are random (``torch.Generator`` seed 0). ``--device``
defaults to the card; ``--full`` serves the published widths instead of
the reduced config.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch import configs  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.runtime.serve import BatchingEngine  # noqa: E402
from repro_torch.utils.device import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--full", action="store_true",
                    help="the published widths instead of the reduced "
                         "config")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    spec = configs.get(args.arch)
    cfg = spec.config if args.full else spec.reduced
    params = init_params(tfm.model_defs(cfg),
                         torch.Generator(device=dev).manual_seed(0),
                         cfg.param_dtype, device=dev)
    eng = BatchingEngine(cfg, params, batch=args.slots, max_len=64,
                         device=dev)
    del params                 # the engine holds its leaves cast once

    rng = np.random.RandomState(0)
    pending = [[int(t) for t in rng.randint(0, cfg.vocab_size,
                                            size=rng.randint(3, 8))]
               for _ in range(args.requests)]
    t0 = time.time()
    done_count = 0
    submitted = {}
    while done_count < args.requests:
        while pending:
            rid = eng.submit(pending[0])
            if rid is None:
                break                      # no free slot: decode to drain
            submitted[rid] = pending.pop(0)
        finished = eng.step(stop_len=args.gen)
        for rid in finished:
            done_count += 1
            print(f"req {rid}: prompt={submitted[rid][:4]}… -> "
                  f"{eng.outputs[rid]}")
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in eng.outputs.values())
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "the CPU")
    print(f"\nserved {args.requests} requests, {total_tokens} tokens in "
          f"{dt:.1f}s ({total_tokens / dt:.1f} tok/s on {where}, "
          f"{cfg.name})")


if __name__ == "__main__":
    main()
