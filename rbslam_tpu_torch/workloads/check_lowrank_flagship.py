"""Accuracy gate of the lowrank filter path at the reference scale (port
of scripts/check_lowrank_flagship.py): m=509 (n_lin 512), T=192, N_P=100,
multinomial resampling, over n seeds' datasets: the lowrank path without
symmetrization against the xla path with it, both float32, plus the
lowrank path with a bf16 covariance. Prints per seed the aligned position
RMSE, the minimum ESS, the repaired factorizations and the wall time, and
per row the median, the maximum and the count of non-finite RMSEs.

Run on the GPU:
    python -m rbslam_tpu_torch.workloads.check_lowrank_flagship 20
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import numpy as np
import torch

from ..engines import RBPFConfig, run_rbpf
from ..metrics import aligned_position_rmse
from .common import Timer
from .dense_mag import DenseMagConfig, build_from_config

ROWS = (("lowrank", False, "float32"), ("xla", True, "float32"),
        ("lowrank", False, "bfloat16"))


def run(n_seeds: int = 5, *, device="cuda",
        generator: torch.Generator | None = None, m_basis: int = 509,
        n_particles: int = 100, n_laps: int = 3,
        m_sim: int = 2000) -> dict:
    """One filter run per seed and row; seed s simulates its dataset from
    1 + s on the host. ``generator`` (on ``device``) supplies the filter's
    draws of every run in turn; by default run s draws from a generator
    seeded with 100 + s, the same in every row. Returns {"rows": [...]}
    with each row's per-seed lists and its summary."""
    device = torch.device(device)
    out = []
    for kernel, sym, cov_dtype in ROWS:
        rmses, esss, retries, walls = [], [], [], []
        for s in range(n_seeds):
            cfg = DenseMagConfig(seed=1 + s, m_basis=m_basis, m_sim=m_sim,
                                 n_laps=n_laps)
            problem, data = build_from_config(
                cfg, torch.Generator().manual_seed(cfg.seed), device=device)
            rc = RBPFConfig(n_particles=n_particles,
                            resampling="multinomial", cov_dtype=cov_dtype,
                            symmetrize_cov=sym, kf_kernel=kernel)
            gen = generator if generator is not None else \
                torch.Generator(device=device).manual_seed(100 + s)
            with Timer(device) as t:
                res = run_rbpf(*problem.rbpf_args(), rc, generator=gen,
                               device=device)
            rmses.append(float(aligned_position_rmse(data.pos,
                                                     res.traj_mean[:, :3])))
            esss.append(float(res.ess.min()))
            retries.append(int(res.chol_retries))
            walls.append(t.elapsed)
            print(f"  seed {s}: rmse={rmses[-1]:.4f} ess_min={esss[-1]:.1f} "
                  f"retries={retries[-1]} wall={walls[-1]:.1f}s", flush=True)
        a = np.array(rmses)
        ok = a[np.isfinite(a)]
        row = {
            "kf_kernel": kernel, "symmetrize_cov": sym,
            "cov_dtype": cov_dtype, "rmse": rmses, "ess_min": esss,
            "chol_retries": retries, "wall_s": walls,
            "rmse_median": float(np.median(ok)) if ok.size else math.nan,
            "rmse_max": float(ok.max()) if ok.size else math.nan,
            "n_nan": int(a.size - ok.size),
        }
        print(f"{kernel} sym={sym} {cov_dtype}: rmse median="
              f"{row['rmse_median']:.4f} max={row['rmse_max']:.4f} "
              f"n_nan={row['n_nan']} wall(min)={min(walls):.1f}s", flush=True)
        out.append(row)
    return {"workload": "check-lowrank-flagship", "n_seeds": n_seeds,
            "m_basis": m_basis, "n_particles": n_particles,
            "n_steps": 64 * n_laps,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "rows": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("nseeds", type=int, nargs="?", default=5)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip())
    print(json.dumps(run(args.nseeds, device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
