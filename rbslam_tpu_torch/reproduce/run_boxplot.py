"""The dense-mag disturbance boxplot at the reference's size (port of
scripts/run_boxplot.py; examples/slam-dense-mag/main.m:37-60): nSim=20 runs
at each constant disturbance o in {0, 1, 5, 10}, N_P=100, m=512 (+3
linear), m_sim=2000, N_K=10: the batched EKF, the RBPF (xla path) and the
information-form RBPS (woodbury ancestor form), through
``workloads.dense_mag.run_comparison``.

The filter keeps its per-step re-symmetrization (``symmetrize_cov=True``):
without it the float32 covariance drifts from symmetric over T=192 and the
weights go NaN in 19-20 of 20 runs at every o (the JAX script's finding).
Runs that still end NaN are counted in ``nan_runs``.

Run i simulates its dataset from seed 1 + i and draws from a generator of
the same seed, so a ``--disturbances`` subset gives exactly the numbers of
those entries in the full run, and parts merge:

    python -m rbslam_tpu_torch.reproduce.run_boxplot --disturbances 0 1 \\
        --out part_a.json
    python -m rbslam_tpu_torch.reproduce.run_boxplot --merge part_a.json \\
        part_b.json --out dense_mag_boxplot.json
"""

from __future__ import annotations

import argparse
import math
import time
from contextlib import nullcontext
from dataclasses import replace

from ..workloads.dense_mag import DenseMagConfig, run_comparison
from .common import Bf16MatmulInputs, emit, load, setup, stamp

CONFIG = DenseMagConfig(
    n_particles=100, n_sweeps=10, m_basis=512, m_sim=2000,
    ancestor_form="woodbury", symmetrize_cov=True,
)
DISTURBANCES = (0.0, 1.0, 5.0, 10.0)
N_SIM = 20
METHODS = ("ekf", "pf", "ps")


def nan_runs(raw: dict) -> dict:
    """Non-finite position RMSEs per disturbance and method."""
    return {o: {m: sum(not math.isfinite(v) for v in r[m]) for m in METHODS}
            for o, r in raw.items()}


def run(cfg: DenseMagConfig, disturbances=DISTURBANCES, n_sim: int = N_SIM,
        *, device="cuda", bf16_matmul_inputs: bool = False,
        **extra) -> dict:
    """``run_comparison`` with the JAX script's keys (``wall_s``, and
    ``extra`` such as ``kf_kernel``), ``nan_runs``, ``cov_dtype``,
    ``matmul_inputs`` and the card's stamp. ``bf16_matmul_inputs``: run
    under ``Bf16MatmulInputs`` (the TPU's default product precision)."""
    device = setup(device)
    t0 = time.perf_counter()
    with Bf16MatmulInputs() if bf16_matmul_inputs else nullcontext():
        out = run_comparison(cfg, disturbances=tuple(disturbances),
                             n_sim=n_sim, device=device)
    out["wall_s"] = time.perf_counter() - t0
    out.update(extra)
    out["cov_dtype"] = cfg.cov_dtype
    out["matmul_inputs"] = "bfloat16" if bf16_matmul_inputs else "float32"
    out["nan_runs"] = nan_runs(out["raw"])
    out.update(stamp(device))
    return out


def merge(parts: list[dict]) -> dict:
    """One result from runs over disjoint disturbance subsets of the same
    configuration, its entries in ascending order of o; ``wall_s`` is the
    parts' sum, and the stamps must agree."""
    first = parts[0]
    by_o = {}
    for part in parts:
        for k, v in part.items():
            if k not in ("raw", "rmse_by_disturbance", "nan_runs",
                         "wall_s") and v != first[k]:
                raise ValueError(f"parts disagree on {k!r}: {v!r} and "
                                 f"{first[k]!r}")
        for o in part["raw"]:
            if o in by_o:
                raise ValueError(f"disturbance {o} is in two parts")
            by_o[o] = part
    order = sorted(by_o, key=float)
    out = dict(first)
    for key in ("rmse_by_disturbance", "raw", "nan_runs"):
        out[key] = {o: by_o[o][key][o] for o in order}
    out["wall_s"] = sum(p["wall_s"] for p in parts)
    return out


def main(argv=None, config: DenseMagConfig = CONFIG, doc: str = __doc__,
         **extra) -> None:
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--disturbances", type=float, nargs="+",
                    default=list(DISTURBANCES))
    ap.add_argument("--runs", type=int, default=N_SIM,
                    help="runs per disturbance (nSim)")
    ap.add_argument("--sweeps", type=int, default=config.n_sweeps)
    ap.add_argument("--bf16-matmul-inputs", action="store_true",
                    help="round every float32 product's operands to "
                         "bfloat16, as the TPU's default precision did in "
                         "the JAX package's runs (a diagnostic)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--merge", nargs="+", metavar="JSON",
                    help="merge these parts instead of running")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    if args.merge:
        emit(merge([load(p) for p in args.merge]), args.out)
        return
    cfg = replace(config, n_sweeps=args.sweeps)
    emit(run(cfg, args.disturbances, args.runs, device=args.device,
             bf16_matmul_inputs=args.bf16_matmul_inputs, **extra), args.out)


if __name__ == "__main__":
    main()
