"""Accuracy gate of the information-form smoother with bfloat16 storage at
the mag3d size (VERDICT r5's next item): over n seeds' datasets (bean_6D,
m=512, n_lin 515, m_sim=2000, T=192, the dense-mag workload's theta and
Q), ``run_rbps_information_form`` with N_P=100, 10 sweeps, multinomial
resampling, woodbury ancestor form, symmetrized, once with float32 and
once with bfloat16 storage on the same dataset and the same draws. Prints
per seed the aligned position RMSE of the last sweep and the wall time,
and per dtype the median (against the filter gate's 0.3 m), the maximum
and the count of non-finite RMSEs, then one JSON line.

Run on the GPU:
    python -m rbslam_tpu_torch.workloads.check_smoother_bf16 20
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..engines import RBPSConfig, run_rbps_information_form
from ..metrics import aligned_position_rmse
from .common import Timer, report
from .dense_mag import DenseMagConfig, build_from_config

DTYPES = ("float32", "bfloat16")


def run(n_seeds: int = 20, dtypes=DTYPES, *, device="cuda",
        m_basis: int = 512, n_particles: int = 100, n_sweeps: int = 10,
        n_laps: int = 3, m_sim: int = 2000) -> dict:
    """Seed s simulates its dataset from 1 + s on the host and draws from
    a generator seeded with 100 + s, the same for every dtype."""
    device = torch.device(device)
    rows = []
    for cov_dtype in dtypes:
        rmses, walls = [], []
        for s in range(n_seeds):
            cfg = DenseMagConfig(seed=1 + s, m_basis=m_basis, m_sim=m_sim,
                                 n_laps=n_laps)
            problem, data = build_from_config(
                cfg, torch.Generator().manual_seed(cfg.seed), device=device)
            sc = RBPSConfig(n_particles=n_particles, n_sweeps=n_sweeps,
                            resampling="multinomial", cov_dtype=cov_dtype,
                            ancestor_form="woodbury", symmetrize_cov=True)
            gen = torch.Generator(device=device).manual_seed(100 + s)
            with Timer(device) as t:
                res = run_rbps_information_form(*problem.rbpf_args(), sc,
                                                generator=gen, device=device)
            rmses.append(float(aligned_position_rmse(
                data.pos, res.XNK[-1, :, :3])))
            walls.append(t.elapsed)
            print(f"  {cov_dtype} seed {s}: rmse={rmses[-1]:.4f} "
                  f"wall={walls[-1]:.1f}s", flush=True)
        a = np.array(rmses)
        ok = a[np.isfinite(a)]
        rows.append({
            "cov_dtype": cov_dtype, "rmse": rmses, "wall_s": walls,
            "rmse_median": float(np.median(ok)) if ok.size else math.nan,
            "rmse_max": float(ok.max()) if ok.size else math.nan,
            "n_nan": int(a.size - ok.size),
        })
        print(f"{cov_dtype}: rmse median={rows[-1]['rmse_median']:.4f} "
              f"max={rows[-1]['rmse_max']:.4f} n_nan={rows[-1]['n_nan']}",
              flush=True)
    return {"workload": "check-smoother-bf16", "n_seeds": n_seeds,
            "m_basis": m_basis, "n_particles": n_particles,
            "n_sweeps": n_sweeps, "n_steps": 64 * n_laps,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("nseeds", type=int, nargs="?", default=20)
    ap.add_argument("--dtype", nargs="+", default=list(DTYPES),
                    choices=DTYPES, help="storage dtypes to run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    report(run(args.nseeds, args.dtype, device=args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
