"""The paper's Figure 6/8 comparison on the port: the nine distributed-SGD
algorithms racing to a target error (real training, modelled time)
through ``repro_torch.core.async_engine.PSEngine``, with the ASCII
error-over-time curves and the paper's four claims. The port of
examples/paper_figures.py.

    PYTHONPATH=src python examples/paper_figures_torch.py --device cpu
    PYTHONPATH=src python examples/paper_figures_torch.py [--iters 2000]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.async_engine import (ALGORITHMS, PSEngine,  # noqa: E402
                                           SimConfig)
from repro_torch.core.easgd import EASGDConfig  # noqa: E402
from repro_torch.ps import problems  # noqa: E402

# the settings of benchmarks/common.py's default_engine: its MLP problem
# (4096 / 1024 Gaussian-mixture samples of 64 features, 10 classes, a
# 64-wide two-layer ReLU MLP, batches of 64), η = ρ = 0.05, μ 0.9, four
# workers, 2 ms of modelled compute a gradient
MLP_PROBLEM = dict(n_train=4096, n_test=1024, d_in=64, d_hidden=64,
                   n_classes=10, batch=64, noise=1.6, depth=2)
EASGD = dict(eta=0.05, rho=0.05, mu=0.9)
N_WORKERS, T_COMPUTE = 4, 2e-3


def default_engine(seed=0, n_workers=N_WORKERS, t_compute=T_COMPUTE,
                   problem="mlp", device=None) -> PSEngine:
    """``problem``: "mlp", the benchmarks' MLP problem (the port's
    ``jax-mlp`` at its sizes), or "numpy-mlp", the numpy MLP every PS test
    pins the runtime with."""
    if problem == "mlp":
        w0, grad_fn, err_fn = problems.make_jax_mlp(seed=seed, device=device,
                                                    **MLP_PROBLEM)
    else:
        w0, grad_fn, err_fn = problems.make_numpy_mlp(seed=seed,
                                                      device=device)
    sim = SimConfig(n_workers=n_workers, t_compute=t_compute, seed=seed)
    return PSEngine(grad_fn, err_fn, w0, EASGDConfig(**EASGD), sim)


def ascii_curve(history, width=48, t_max=None) -> str:
    if not history:
        return ""
    t_max = t_max or history[-1][0]
    cells = [" "] * width
    for t, _, err in history:
        x = min(int(t / t_max * (width - 1)), width - 1)
        cells[x] = "#" if err > 0.5 else ("+" if err > 0.3 else ".")
    return "".join(cells)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--device", default=None, help="cuda (the default) or "
                                                   "cpu")
    ap.add_argument("--problem", default="mlp", choices=["mlp", "numpy-mlp"])
    args = ap.parse_args(argv)

    eng = default_engine(seed=0, problem=args.problem, device=args.device)
    results, t_max = {}, 0.0
    for algo in ALGORITHMS:
        res = eng.run(algo, total_iters=args.iters)
        results[algo] = res
        t_max = max(t_max, res.total_time_s)
        print(f"ran {algo:16s} final_err={res.final_metric:.3f} "
              f"time={res.total_time_s:.2f}s")

    print("\nerror over modelled time ('#'>0.5, '+'>0.3, '.'<=0.3):")
    for algo, res in sorted(results.items(),
                            key=lambda kv: kv[1].final_metric):
        print(f"  {algo:16s} |{ascii_curve(res.history, t_max=t_max)}|")

    def t_to(algo, target=0.30):
        for t, _, e in results[algo].history:
            if e <= target:
                return t
        return float("inf")

    print("\npaper claims (Fig 6/8):")
    for ours, theirs in (("async_easgd", "async_sgd"),
                         ("async_measgd", "async_msgd"),
                         ("hogwild_easgd", "hogwild_sgd"),
                         ("sync_easgd", "original_easgd")):
        ok = t_to(ours) <= t_to(theirs)
        print(f"  {ours} faster than {theirs}: "
              f"{'REPRODUCED' if ok else 'NOT reproduced'} "
              f"({t_to(ours):.2f}s vs {t_to(theirs):.2f}s)")
    return results


if __name__ == "__main__":
    main()
