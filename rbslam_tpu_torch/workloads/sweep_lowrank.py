"""Sweep the lowrank filter's rebase period against block_gather and xla
(port of scripts/sweep_lowrank.py).

    python -m rbslam_tpu_torch.workloads.sweep_lowrank [--out PATH]
        [--device cuda]

At the headline shape (N_P=16384, m=125+3, T=192, bf16 covariance,
systematic resampling every step, no symmetrization) it runs
``bench.bench_rbpf`` on xla, block_gather and lowrank with r in
{4, 8, 16, 32, 64}, in that order, and prints one JSON line a
configuration with the script's keys: ``config``, ``particle_steps_per_s``,
``step_ms`` (best of 3 after a warm-up) and ``wall_s`` (the whole row,
problem build and warm-up included). With ``--out`` the rows are also
written there as one JSON list. The filter's default period stays 8; the
sweep reports and does not retune.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .. import bench

CONFIGS = (("xla", 8), ("block_gather", 8),
           *(("lowrank", r) for r in (4, 8, 16, 32, 64)))
HEADLINE = (125, 16384, 192)     # m_basis, N_P, T


def run(*, device, shape=HEADLINE) -> list:
    """Every configuration's row, each printed as it comes."""
    m_basis, n_particles, n_steps = shape
    rows = []
    for kf_kernel, period in CONFIGS:
        t0 = time.time()
        thr, elapsed, T = bench.bench_rbpf(
            m_basis, n_particles, n_steps, cov_dtype="bfloat16",
            symmetrize=False, kf_kernel=kf_kernel, lowrank_period=period,
            device=device)
        tag = kf_kernel + (f"-r{period}" if kf_kernel == "lowrank" else "")
        rows.append({"config": tag, "particle_steps_per_s": round(thr, 1),
                     "step_ms": round(elapsed / T * 1e3, 3),
                     "wall_s": round(time.time() - t0, 1)})
        print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the rows here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    args = ap.parse_args(argv)
    rows = run(device=bench.start(args.device, "sweep_lowrank"))
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
