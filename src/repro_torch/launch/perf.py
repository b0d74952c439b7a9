"""Labelled variants of three dry-run cells (the port of
``repro/launch/perf.py``): hypothesis -> change -> re-trace -> re-count,
each record appended to ``results/perf_torch.jsonl``. Every number is a
count of rank 0's step priced on the H100's data sheet
(``launch.dryrun``), not a time taken.

    PYTHONPATH=src python -m repro_torch.launch.perf [--only gemma3-4b]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch import configs
from repro_torch.launch.dryrun import run_cell


def variants() -> list:
    """(cell, variant_name, elastic_overrides, cfg_transform[, mb])."""
    v = []

    # cell A: gemma3-4b × train_4k × pod (memory-dominated)
    A = ("gemma3-4b", "train_4k", "pod")
    v.append((A, "A1_bigger_attn_blocks", None,
              lambda c: dataclasses.replace(c, attn_q_block=1024,
                                            attn_kv_block=4096)))
    v.append((A, "A2_bigger_loss_chunks", None,
              lambda c: dataclasses.replace(c, loss_chunk=131072)))
    v.append((A, "A3_both", None,
              lambda c: dataclasses.replace(c, attn_q_block=1024,
                                            attn_kv_block=4096,
                                            loss_chunk=131072)))
    v.append((A, "A4_blocks_mb4", None,
              lambda c: dataclasses.replace(c, attn_q_block=1024,
                                            attn_kv_block=4096), 4))
    v.append((A, "A5_blocks_remat_dots", None,
              lambda c: dataclasses.replace(c, attn_q_block=1024,
                                            attn_kv_block=4096,
                                            remat="none"), 8))

    # cell B: deepseek-v2-236b × train_4k × pod (MoE and MLA: the port
    # records its NotImplementedError until the placement of those kinds)
    B = ("deepseek-v2-236b", "train_4k", "pod")
    v.append((B, "B1_no_ep_expert_tp", None,
              lambda c: dataclasses.replace(c, moe_ep=False)))
    v.append((B, "B2_capacity_1.0", None,
              lambda c: dataclasses.replace(
                  c, moe=dataclasses.replace(c.moe, capacity_factor=1.0))))
    v.append((B, "B3_ep_and_cap1_bigblocks", None,
              lambda c: dataclasses.replace(
                  c, moe=dataclasses.replace(c.moe, capacity_factor=1.0),
                  attn_q_block=1024, attn_kv_block=4096)))

    # cell C: gemma3-27b × train_4k × multipod (the cross-pod elastic
    # exchange)
    C = ("gemma3-27b", "train_4k", "multipod")
    v.append((C, "C0_unpacked_nooverlap",
              dict(packed=False, overlap=False), None))
    v.append((C, "C1_packed_nooverlap",
              dict(packed=True, overlap=False), None))
    # C2 is the dry run's baseline (packed and overlapped)
    v.append((C, "C3_packed_overlap_signef",
              dict(compression="sign_ef"), None))
    v.append((C, "C4_msgd_plain_dp", dict(mode="msgd"), None))
    return v


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=None)
    ap.add_argument("--out", default="results/perf_torch.jsonl")
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    done = set()
    if os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add(r.get("variant"))

    for item in variants():
        (arch, shape, mesh_kind), name, eo, cfg_tf = item[:4]
        mb = item[4] if len(item) > 4 else None
        if args.only and args.only not in arch:
            continue
        if name in done:
            print(f"SKIP {name}")
            continue
        cfg = configs.get(arch).config
        cfg2 = cfg_tf(cfg) if cfg_tf else None
        print(f"=== {name}: {arch} × {shape} × {mesh_kind} ===", flush=True)
        rec = run_cell(arch, shape, mesh_kind, args.out,
                       elastic_overrides=eo, variant=name, cfg_override=cfg2,
                       microbatches_override=mb)
        if rec["ok"]:
            rl = rec["roofline"]
            print(f"  c={rl['compute_s']:.2f} m={rl['memory_s']:.2f} "
                  f"n={rl['collective_s']:.2f} peak="
                  f"{rec['peak_bytes_per_device'] / 2**30:.1f}GiB "
                  f"useful={rec['useful_flops_ratio']:.3f} (counts priced "
                  f"on {rec['chip']})", flush=True)
        else:
            print(f"  FAIL {rec['error'][:300]}", flush=True)


if __name__ == "__main__":
    main()
