"""Where one smoother run's time goes on the GPU.

    python -m rbslam_tpu_torch.workloads.profile_smoother \
        [--workload mag3d] [--smoother info_form] [--ancestor-form woodbury] \
        [--cov-dtype float32] [--particles 100] [--basis 512] [--steps 192] \
        [--sweeps 3] [--out profile.txt]

``--workload mag3d`` builds the dense-mag problem (bean_6D, seed 1,
systematic resampling, the reference bench row's configuration);
``--workload radio`` the dense-radio line problem (multinomial
resampling; ``--particles 100 --basis 128 --steps 32 --sweeps 20`` is its
reference size). Runs the smoother once to warm up, twice for the best
un-profiled wall time, once under ``torch.cuda.set_sync_debug_mode`` to
count the host-device synchronizations, then once under
``torch.profiler`` (CPU and CUDA activities). Reports particle-steps/s
(N_P T N_K over the wall), the peak device memory, the syncs per step,
the device time per kernel name, the device busy share and the device
operations launched per step. Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
import warnings
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from ..engines import RBPSConfig, run_rbps, run_rbps_information_form
from . import dense_radio
from .dense_mag import build_problem
from .profile_dense_mag import _device_events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", default="mag3d", choices=["mag3d", "radio"])
    ap.add_argument("--smoother", default="info_form",
                    choices=["info_form", "cpf_as"])
    ap.add_argument("--ancestor-form", default="woodbury",
                    choices=["woodbury", "cholesky"])
    ap.add_argument("--cov-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--basis", type=int, default=512)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--sweeps", type=int, default=3)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_smoother needs a CUDA device")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    if args.workload == "mag3d":
        problem, _ = build_problem(args.basis, args.steps, seed=1,
                                   device=device)
        resampling = "systematic"
    else:
        problem, _ = dense_radio.build_problem(
            dense_radio.DenseRadioConfig(n_steps=args.steps,
                                         m_basis=args.basis),
            torch.Generator().manual_seed(1), device=device)
        resampling = "multinomial"
    cfg = RBPSConfig(n_particles=args.particles, n_sweeps=args.sweeps,
                     resampling=resampling, cov_dtype=args.cov_dtype,
                     ancestor_form=args.ancestor_form)
    smoother = (run_rbps_information_form if args.smoother == "info_form"
                else run_rbps)
    gen = torch.Generator(device=device)

    def run(seed):
        gen.manual_seed(seed)
        res = smoother(*problem.rbpf_args(), cfg, generator=gen,
                       device=device)
        torch.cuda.synchronize()
        return res

    res = run(0)
    retries = res.chol_retries.tolist()
    del res
    T, steps = args.steps, args.steps * args.sweeps
    torch.cuda.reset_peak_memory_stats()
    best = float("inf")
    for seed in (2, 3):
        t0 = time.perf_counter()
        run(seed)
        best = min(best, time.perf_counter() - t0)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.set_sync_debug_mode("warn")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        run(4)
    torch.cuda.set_sync_debug_mode("default")
    sync_sites = defaultdict(int)
    for w in caught:
        if "synchroniz" in str(w.message):
            sync_sites[f"{w.filename.split('rbslam_tpu_torch/')[-1]}:"
                       f"{w.lineno}"] += 1
    n_syncs = sum(sync_sites.values())

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(1)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = _device_events(prof)
    by_name = defaultdict(lambda: [0, 0.0])
    for name, us in events:
        by_name[name][0] += 1
        by_name[name][1] += us
    busy_us = sum(us for _, us in events)
    form = (f" {args.ancestor_form}" if args.smoother == "info_form" else "")
    lines = [
        f"card: {card}",
        f"config: {args.workload} {args.smoother}{form} N_P={args.particles} "
        f"m={args.basis} (n_lin={problem.model.n_lin}) T={T} "
        f"{args.sweeps} sweeps {args.cov_dtype} {resampling}",
        f"chol_retries per sweep in the warm-up run: {retries}",
        f"without the profiler: best of 2 {best * 1e3:.3f} ms "
        f"({best * 1e3 / steps:.4f} ms/step, "
        f"{args.particles * steps / best:.1f} particle-steps/s)",
        f"peak device memory over those runs: {peak_gb:.3f} GB",
        f"host-device synchronizations: {n_syncs} in one run "
        f"({n_syncs / steps:.2f} per step), by call site: "
        f"{dict(sorted(sync_sites.items(), key=lambda kv: -kv[1]))}",
        f"wall {wall_us / 1e3:.3f} ms under the profiler "
        f"({wall_us / 1e3 / steps:.4f} ms/step)",
        f"device busy {busy_us / 1e3:.3f} ms = {busy_us / wall_us:.3f} of "
        f"wall (idle share {1 - busy_us / wall_us:.3f}); "
        f"{busy_us / 1e3 / steps:.4f} ms/step, "
        f"{busy_us / (best * 1e6):.3f} of the un-profiled wall",
        f"device operations: {len(events)} ({len(events) / steps:.1f} per "
        "step)",
        "device time by kernel (count, total ms, share of busy):",
    ]
    for name, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1]):
        lines.append(f"  {us / 1e3:10.3f} ms {n:7d}x {us / busy_us:6.3f}  "
                     f"{name[:110]}")
    report = "\n".join(lines)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    print(report)
    return 0


if __name__ == "__main__":
    sys.exit(main())
