"""The lowrank filter of this checkout against another's (the parent
commit's), in turns on one card: particle-steps/s of each run,
host-device syncs a step by call site, and whether the two give the
same bits.

    python -m rbslam_tpu_torch.workloads.filter_ab --parent DIR \
        [--shape headline] [--pairs 5] [--out FILE]

``DIR`` is the root of another checkout (for example a ``git archive``
of the parent commit unpacked into a directory that ``.gitignore``
lists), imported under another name beside this one. Both build the
same dataset (bean_6D, T=192, m_sim=512, seed 1) and run ``run_rbpf``
with the same generator seed, as chip_smoke.py phases 4 and 5 do:
``headline`` N_P=16384, m=125, bf16; ``reference`` N_P=4096, m=509,
f32; ``131k`` bench.py's 131,072-particle row (m=125, bf16, no
trajectory history); systematic resampling, no symmetrization, lowrank
r=8 (the main path). After one warm-up
run each, ``--pairs`` pairs of timed runs (one run each, a wall ending in
``torch.cuda.synchronize()``), the order alternating (parent, this; this,
parent; ...), each run with its own seed, the same in both trees. Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import statistics
import subprocess
import sys
import time

import torch

from .basis_kernel_times import load_port
from .profile_dense_mag import count_syncs, sync_report

# (N_P, m, covariance dtype, store_trajectories)
SHAPES = {"headline": (16384, 125, "bfloat16", True),
          "reference": (4096, 509, "float32", True),
          "131k": (131072, 125, "bfloat16", False)}
T = 192


def _runner(package: str, shape: str, device):
    """run(seed) -> RBPFResult of the port imported as ``package``."""
    engines = importlib.import_module(f"{package}.engines")
    dense_mag = importlib.import_module(f"{package}.workloads.dense_mag")
    n, m, cov_dtype, store = SHAPES[shape]
    problem, _ = dense_mag.build_problem(m, T, seed=1, m_sim=512,
                                         device=device)
    cfg = engines.RBPFConfig(n_particles=n, resampling="systematic",
                             cov_dtype=cov_dtype, symmetrize_cov=False,
                             kf_kernel="lowrank", lowrank_period=8,
                             store_trajectories=store)
    gen = torch.Generator(device=device)

    def run(seed):
        gen.manual_seed(seed)
        res = engines.run_rbpf(*problem.rbpf_args(), cfg, generator=gen,
                               device=device)
        torch.cuda.synchronize(device)
        return res

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="root of the other checkout of the port")
    ap.add_argument("--shape", default="headline", choices=list(SHAPES))
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("filter_ab needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    load_port(args.parent, "_parent_rbslam_tpu_torch")
    runs = {"parent": _runner("_parent_rbslam_tpu_torch", args.shape,
                              device),
            "this": _runner(__package__.rsplit(".", 1)[0], args.shape,
                            device)}
    n = SHAPES[args.shape][0]
    first = {k: run(0) for k, run in runs.items()}
    same = all(torch.equal(getattr(first["this"], f),
                           getattr(first["parent"], f))
               for f in ("ancestors", "traj_mean", "xl", "P", "logw"))
    del first
    print(f"{card}; parent = {args.parent}")
    print(f"{card}; {args.shape} N_P={n} T={T} lowrank: the two "
          f"trees' runs with seed 0 give equal ancestors, traj_mean, xl, P, "
          f"logw: {same}")
    syncs = {}
    for k, run in runs.items():
        syncs[k] = count_syncs(lambda run=run: run(1))
        print(f"[{k}]", "\n".join(sync_report(syncs[k], T - 1)))
    rate = {k: [] for k in runs}
    for i in range(args.pairs):
        order = ("parent", "this") if i % 2 == 0 else ("this", "parent")
        for k in order:
            t0 = time.perf_counter()
            runs[k](2 + i)
            rate[k].append(n * T / (time.perf_counter() - t0))
        print(f"pair {i} ({order[0]} first): parent {rate['parent'][-1]:.1f}"
              f", this {rate['this'][-1]:.1f} particle-steps/s")
    for k in runs:
        print(f"{k}: median {statistics.median(rate[k]):.1f} particle-steps/s"
              f" (least {min(rate[k]):.1f}, most {max(rate[k]):.1f})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "shape": args.shape,
                       "equal_bits": same,
                       "particle_steps_per_s": rate, "syncs": syncs}, f,
                      indent=1)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
