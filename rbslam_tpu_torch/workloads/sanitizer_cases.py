"""What compute-sanitizer's tools run over: the basis kernels K1, K4, K6 and
K7 at chip_smoke.py phase 3's shapes (every case of
``basis_kernel_times.CASES``, both planner forms), then two steps of the
headline lowrank filter (N_P=16384, m=125, bf16, r=8: K4 once, K1 and K2
twice, K3 once). Each kernel's output is synchronized and held against
its plain version (f32 1e-4, bf16 2e-2 of the scale), and the filter's
estimates must be finite; exit code 1 if not.

    for tool in memcheck racecheck initcheck synccheck; do
        compute-sanitizer --tool $tool --error-exitcode 9 \\
            python -m rbslam_tpu_torch.workloads.sanitizer_cases
    done

Needs a CUDA device.
"""

from __future__ import annotations

import sys

import torch

from .. import kernels
from ..engines import RBPFConfig, run_rbpf
from .basis_kernel_times import CASES, call, case_inputs
from .dense_mag import build_problem

PLAIN = {
    "jac3d_rows": lambda c, x, q, nl, dt:
        kernels.mag3d_jacobian_rows_plain(c, x, q, nl, dt),
    "jac3d": lambda c, x, q, nl, dt: kernels.mag3d_jacobian_plain(c, x, q, nl),
    "grad_basis": lambda c, x, q, nl, dt: kernels.grad_basis_plain(c, x),
    "phi_basis": lambda c, x, q, nl, dt: kernels.phi_basis_plain(c, x),
}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def main(argv=None) -> int:
    del argv
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    ok = True
    for i, (name, n, d, m, nl_pad, dtype) in enumerate(CASES):
        basis, x, q = case_inputs(n, d, m, device, seed=i)
        consts = kernels.pack_basis_constants(basis, device)
        out = call(kernels, name, consts, x, q, nl_pad, dtype)
        ref = PLAIN[name](consts, x, q, nl_pad, dtype)
        torch.cuda.synchronize(device)
        err = float((out.float() - ref.float()).abs().max())
        rel = err / max(float(ref.float().abs().max()), 1e-30)
        good = rel <= TOL[out.dtype]
        ok &= good
        print(f"{name} N={n} d={d} m={m} {dtype}: rel err {rel:.3e} "
              f"{'ok' if good else 'FAILED'}", flush=True)
    problem, _ = build_problem(125, 3, seed=1, m_sim=512, device=device)
    cfg = RBPFConfig(n_particles=16384, resampling="systematic",
                     cov_dtype="bfloat16", symmetrize_cov=False,
                     kf_kernel="lowrank", lowrank_period=8)
    kernels.reset_launch_counts()
    res = run_rbpf(*problem.rbpf_args(), cfg,
                   generator=torch.Generator(device=device).manual_seed(0),
                   device=device)
    torch.cuda.synchronize(device)
    finite = bool(torch.isfinite(res.traj_mean).all()) and bool(
        torch.isfinite(res.xl_mean).all())
    ok &= finite
    print(f"lowrank filter, 2 steps at N_P=16384, m=125, bf16: launches "
          f"{kernels.launch_counts()}, finite {finite}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
