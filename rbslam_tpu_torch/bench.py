"""Benchmark: RBPF particle-step throughput on the flagship dense-mag model
(port of bench.py).

    python -m rbslam_tpu_torch.bench [--quick] [--device cuda]
        [--extra-out PATH] [bench.py's other flags]

Prints the card's name and power limit first (``card: cpu`` on the CPU),
then one JSON line a row, each with bench.py's four keys ``metric``,
``value``, ``unit``, ``vs_baseline``, in bench.py's order: the gridded
terrain PF; without ``--quick`` or ``--skip-extras`` the reference-scale
lowrank filter in float32 and in bfloat16, the information-form smoother
and the 131,072-particle filter without trajectories; and the headline
row last. ``vs_baseline`` divides the headline by a single-threaded
NumPy per-particle loop of the reference's filter, run on this host.

Every row runs its engine once to warm up and then ``repeats`` times, on
a device generator seeded 0 for the warm-up and ``i + 1`` for repeat
``i`` (the JAX package's ``fold_in(key, i)``); a timed call ends in
``torch.cuda.synchronize()``. TF32 is off.

Departures from bench.py:

- ``--pallas-basis`` / ``--no-pallas-basis`` are not taken: on a CUDA
  device the mag3d model always evaluates its Jacobians through the basis
  kernels, so the metric strings carry no ``,pallas-basis`` tag.
- bench.py's ``enable_compilation_cache`` has no counterpart: the kernel
  build cache of ``kernels/_lib.py`` does its job.
- ``--device`` is new and defaults to ``cuda``; without a card that exits
  non-zero. ``--device cpu`` runs the kernels' plain versions (tests).
- The HBM fraction keeps bench.py's least-bytes formula (one read and one
  write of the covariance ensemble a step, n_lin padded to 128 on the
  kernel paths) but divides by the H100's 3.35e12 B/s, not v5e's 819e9.
- The extras (bench.py's ``BENCH_EXTRA.json``) are written only to
  ``--extra-out PATH``, with the 131,072-particle row's peak device memory
  added.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .basis import hypercube_basis
from .data.fields import draw_scalar_potential_field
from .engines import (
    PFConfig,
    RBPFConfig,
    RBPSConfig,
    run_pf_localization,
    run_rbpf,
    run_rbps_information_form,
)
from .math.quaternions import qinv, qmul
from .models.terrain import TerrainModel, make_gridded_terrain_model
from .reproduce.common import setup, stamp
from .utils.profiling import trace_to
from .workloads.dense_mag import build_problem
from .workloads.mag_localization import (
    _heading_quats,
    _quat,
    _test_loop,
    default_Q,
)

HBM_BYTES_PER_S = 3.35e12   # H100 SXM


def _build_problem(m_basis, n_particles, n_steps, seed=1, *, device):
    """bench.py:23-55's problem: a bean_6D dataset (laps of 64 steps,
    m_sim = 512, theta = (650, 1.2, 200, 10)) simulated from ``seed`` and
    an m_basis-function mag3d model on ``device``. ``n_particles`` is
    unused, as in bench.py. Returns (Problem, dataset)."""
    return build_problem(m_basis, n_steps, seed=seed, m_sim=512,
                         device=device)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_of(run, repeats) -> float:
    """Run ``run(0)`` to warm up, then ``run(i + 1)`` for i < repeats;
    the best wall time of the repeats."""
    run(0)
    best = math.inf
    for i in range(repeats):
        t0 = time.perf_counter()
        run(i + 1)
        best = min(best, time.perf_counter() - t0)
    return best


def rbpf_case(m_basis, n_particles, n_steps, cov_dtype="float32",
              symmetrize=False, ess_threshold=1.0, kf_kernel="xla",
              lowrank_period=8, store_trajectories=True, *, device):
    """bench_rbpf's filter: (run, problem, dataset), where ``run(seed)``
    runs it on a device generator seeded ``seed``, synchronizes and
    returns the result."""
    device = torch.device(device)
    problem, data = _build_problem(m_basis, n_particles, n_steps,
                                   device=device)
    cfg = RBPFConfig(n_particles=n_particles, resampling="systematic",
                     cov_dtype=cov_dtype, symmetrize_cov=symmetrize,
                     ess_threshold=ess_threshold, kf_kernel=kf_kernel,
                     lowrank_period=lowrank_period,
                     store_trajectories=store_trajectories)
    gen = torch.Generator(device=device)

    def run(seed):
        gen.manual_seed(seed)
        res = run_rbpf(*problem.rbpf_args(), cfg, generator=gen,
                       device=device)
        _sync(device)
        return res

    return run, problem, data


def bench_rbpf(m_basis, n_particles, n_steps, repeats=3, cov_dtype="float32",
               symmetrize=False, ess_threshold=1.0, kf_kernel="xla",
               lowrank_period=8, store_trajectories=True, *, device="cuda"):
    """(particle-steps/s, best seconds, T) of run_rbpf on bench.py's
    problem, best of ``repeats`` after a warm-up."""
    run, problem, _ = rbpf_case(
        m_basis, n_particles, n_steps, cov_dtype, symmetrize, ess_threshold,
        kf_kernel, lowrank_period, store_trajectories, device=device)
    best = _best_of(run, repeats)
    T = int(problem.y.shape[0])
    return n_particles * T / best, best, T


def bench_rbps_info(m_basis=512, n_particles=100, n_steps=192, n_sweeps=3,
                    repeats=2, *, device="cuda"):
    """Information-form smoother throughput at the reference scale (N_P=100,
    nl=515, T=192, woodbury ancestor form, systematic resampling), best of
    ``repeats`` after a warm-up: (N_P T N_K / best, best, T)."""
    device = torch.device(device)
    problem, _ = _build_problem(m_basis, n_particles, n_steps, device=device)
    cfg = RBPSConfig(n_particles=n_particles, n_sweeps=n_sweeps,
                     resampling="systematic", ancestor_form="woodbury")
    gen = torch.Generator(device=device)

    def run(seed):
        gen.manual_seed(seed)
        run_rbps_information_form(*problem.rbpf_args(), cfg, generator=gen,
                                  device=device)
        _sync(device)

    best = _best_of(run, repeats)
    T = int(problem.y.shape[0])
    return n_particles * T * n_sweeps / best, best, T


TERRAIN_THETA = (10.0, 1.0, 25.0, 4.0)
TERRAIN_EXTENT = 4.0


class TerrainPFProblem(NamedTuple):
    """The inputs of one gridded terrain PF run, float32 on one device."""

    mean_grid: torch.Tensor   # [n_grid, n_grid, 3]
    var_grid: torch.Tensor    # [n_grid, n_grid, 3]
    lo: torch.Tensor          # [2]
    spacing: torch.Tensor     # [2]
    sigma2: float
    u: torch.Tensor           # [T-1, 7] odometry (position, quaternion)
    y: torch.Tensor           # [T, 3] body-frame readings
    init: torch.Tensor        # [N, 7] initial cloud
    Q: torch.Tensor           # [6, 6]
    dt: float
    path: torch.Tensor        # [T, 3] the true positions

    def to(self, device) -> "TerrainPFProblem":
        return self._replace(**{
            f: v.to(device) for f, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})

    def model(self) -> TerrainModel:
        return make_gridded_terrain_model(self.mean_grid, self.var_grid,
                                          self.lo, self.spacing, self.sigma2)

    def run(self, config: PFConfig, *, generator=None, noise=None):
        """run_pf_localization on the problem's device, with the draws of
        ``generator`` or the injected ``noise``."""
        model = self.model()
        return run_pf_localization(
            model.dynamics, model.log_weight, self.u, self.y, self.init,
            self.Q, self.dt, config, n_noise=model.n_noise,
            generator=generator, device=self.y.device, noise=noise)


def build_terrain_problem(n_particles: int, n_steps: int, *, device,
                          seed: int = 0, n_grid: int = 192,
                          m_sim: int = 512) -> TerrainPFProblem:
    """bench.py:127-195's terrain PF problem on ``device`` from a generator
    seeded with ``seed``: a curl-free field (theta = (10, 1, 25, 4),
    ``m_sim`` basis functions) drawn on an ``n_grid`` x ``n_grid`` grid
    over [-4, 4]^2 and along a loop test path, the drawn field as the
    grid's mean and 0.3 as its variance, the path's body-frame readings
    and odometry, and a cloud spread uniformly over the grid."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = np.linspace(-TERRAIN_EXTENT, TERRAIN_EXTENT, n_grid)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    grid_pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
    path = _test_loop(TERRAIN_EXTENT * 0.9, n_steps)
    LLs = np.stack([[-TERRAIN_EXTENT - 1, -TERRAIN_EXTENT - 1, -1.0],
                    [TERRAIN_EXTENT + 1, TERRAIN_EXTENT + 1, 1.0]])
    pts = torch.as_tensor(np.concatenate([grid_pts, path]),
                          dtype=torch.float32, device=device)
    d = draw_scalar_potential_field(
        pts, m_sim, LLs, TERRAIN_THETA,
        z_w=torch.randn(m_sim + 3, generator=gen, device=device),
        z_n=torch.randn((pts.shape[0], 3), generator=gen, device=device))
    _, Rm = _heading_quats(path)
    quat = _quat(Rm.transpose(0, 2, 1))
    y_body = np.einsum("tij,tj->ti", Rm, d.y[X.size:].cpu().numpy())
    qt = torch.as_tensor(quat)
    u = np.concatenate([np.diff(path, axis=0),
                        qmul(qinv(qt[:-1]), qt[1:]).numpy()], -1)
    xy = (2 * torch.rand((n_particles, 2), generator=gen, device=device)
          - 1) * TERRAIN_EXTENT
    init = torch.cat([xy, torch.zeros((n_particles, 1), device=device),
                      torch.as_tensor(quat[0], device=device)
                      .expand(n_particles, 4)], dim=-1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return TerrainPFProblem(
        mean_grid=d.df[:X.size].reshape(n_grid, n_grid, 3),
        var_grid=torch.full((n_grid, n_grid, 3), 0.3, device=device),
        lo=f32([xs[0], xs[0]]), spacing=f32([xs[1] - xs[0]] * 2),
        sigma2=TERRAIN_THETA[3], u=f32(u), y=f32(y_body), init=init,
        Q=default_Q().to(device), dt=0.1, path=f32(path))


def terrain_config(n_particles: int) -> PFConfig:
    """bench.py:185's filter: systematic, the ESS gate at 0.5."""
    return PFConfig(n_particles=n_particles, resampling="systematic",
                    ess_threshold=0.5)


def terrain_position_error(problem: TerrainPFProblem,
                           res) -> tuple[float, float]:
    """(mean over the last two thirds, mean over the last five steps) of
    the distance between traj_mean and the true path in the plane."""
    err = torch.linalg.vector_norm(res.traj_mean[:, :2]
                                   - problem.path[:, :2], dim=-1)
    T = err.shape[0]
    return float(err[T // 3:].mean()), float(err[-5:].mean())


def bench_pf(n_particles, n_steps, repeats=3, *, device="cuda"):
    """Gridded terrain PF throughput (bench.py:127-195's problem,
    :func:`build_terrain_problem`): the engine without a covariance that
    scales to a million particles. (particle-steps/s, best s)."""
    device = torch.device(device)
    problem = build_terrain_problem(n_particles, n_steps, device=device)
    cfg = terrain_config(n_particles)
    gen = torch.Generator(device=device)

    def run(seed):
        gen.manual_seed(seed)
        problem.run(cfg, generator=gen)
        _sync(device)

    best = _best_of(run, repeats)
    return n_particles * n_steps / best, best


def _numpy_grad_basis(pos, NN, L):
    """Real reduced-rank basis-gradient evaluation, vectorized over the
    ensemble exactly as the reference's dense measModel is
    (src/particleFilter.m:124; tools/domain_cartesian_dx.m:146-170):
    d/dx_k prod_j L_j^-1/2 sin(pi n_j (x_j + L_j) / (2 L_j)).

    pos: [N, 3]; NN: [m, 3]; L: [3]. Returns [N, 3, m].
    """
    w = np.pi * NN / (2.0 * L)                   # [m, 3]
    arg = pos[:, None, :] * w[None] + w[None] * L  # [N, m, 3]
    sin = np.sin(arg)
    cos = np.cos(arg)
    norm = float(np.prod(1.0 / np.sqrt(L)))
    out = np.empty((pos.shape[0], 3, NN.shape[0]))
    for k in range(3):
        others = [j for j in range(3) if j != k]
        out[:, k, :] = (
            norm * w[None, :, k] * cos[:, :, k]
            * sin[:, :, others[0]] * sin[:, :, others[1]]
        )
    return out


def numpy_baseline_per_step(m_basis, n_particles, NN, L, n_steps=8):
    """Single-threaded per-particle-loop RBPF step cost, the reference's
    structure: per-particle inverse-CDF resampling (tools/sample.m:30-33),
    one vectorized basis/Jacobian evaluation per step
    (src/particleFilter.m:124), then a loop of per-particle weight and
    Kalman updates with BLAS inner algebra (:126-204). Seconds per
    particle-step."""
    rng = np.random.default_rng(0)
    n_lin = 3 + m_basis
    ny = 3
    P = np.tile(np.eye(n_lin, dtype=np.float64), (n_particles, 1, 1))
    xl = rng.normal(size=(n_particles, n_lin))
    w = np.full(n_particles, 1.0 / n_particles)
    R = 10.0 * np.eye(ny)
    y = rng.normal(size=ny)
    xn = rng.uniform(-0.5, 0.5, size=(n_particles, 7))
    Rnb = np.eye(3) + 0.1 * np.array(
        [[0.0, -1.0, 0.5], [1.0, 0.0, -0.2], [-0.5, 0.2, 0.0]]
    )

    t0 = time.perf_counter()
    for _ in range(n_steps):
        # resample + propagate (per particle, tools/sample.m style)
        ai = np.empty(n_particles, dtype=int)
        for i in range(n_particles):
            ai[i] = np.searchsorted(np.cumsum(w), rng.uniform())
        ai = np.clip(ai, 0, n_particles - 1)
        xn = xn[ai] + 0.01 * rng.normal(size=xn.shape)
        xl = xl[ai]
        P = P[ai]
        # basis eval + body-frame rotation (run_dense3D_magfield.m:265-279):
        # C = Rnb' [I3 | dPhi]
        g = _numpy_grad_basis(xn[:, :3], NN, L)   # [N, 3, m]
        eye3 = np.broadcast_to(np.eye(3), (n_particles, 3, 3))
        C_all = np.einsum(
            "ji,njk->nik", Rnb, np.concatenate([eye3, g], axis=2)
        )
        logw = np.empty(n_particles)
        for i in range(n_particles):
            C = C_all[i]
            e = y - C @ xl[i]
            S = C @ P[i] @ C.T + R
            Lc = np.linalg.cholesky(S)
            v = np.linalg.solve(Lc, e)
            logw[i] = -np.log(np.diag(Lc)).sum() - 0.5 * v @ v
            K = P[i] @ np.linalg.solve(S, C).T
            xl[i] = xl[i] + K @ e
            P[i] = P[i] - K @ S @ K.T
        c = logw.max()
        w = np.exp(logw - c)
        w /= w.sum()
    elapsed = time.perf_counter() - t0
    return elapsed / (n_steps * n_particles)


def numpy_baseline_best(m_basis, n_particles, repeats=3):
    """Best of ``repeats`` baseline costs: the loop is deterministic work,
    so the minimum removes transient host load from vs_baseline."""
    b = hypercube_basis(m_basis, np.array([2.0, 2.0, 1.0]))
    NN = np.asarray(b.NN, dtype=np.float64)
    L = np.asarray(b.L, dtype=np.float64)
    return min(
        numpy_baseline_per_step(m_basis, n_particles, NN, L)
        for _ in range(repeats)
    )


def hbm_fraction(n_particles, m_basis, kf_kernel, cov_dtype, step_s):
    """bench.py's HBM roofline fraction of one filter step: the least
    traffic, one read and one write of the covariance ensemble (n_lin
    padded to 128 on the kernel paths), over the step time and the
    H100's 3.35e12 B/s."""
    n_lin_pad = m_basis + 3
    if kf_kernel in ("block_gather", "lowrank"):
        n_lin_pad = ((n_lin_pad + 127) // 128) * 128
    itemsize = 2 if cov_dtype == "bfloat16" else 4
    min_bytes = 2 * n_particles * n_lin_pad * n_lin_pad * itemsize
    return (min_bytes / step_s) / HBM_BYTES_PER_S


def start(device, prog) -> torch.device:
    """The device, with TF32 off, after printing the card's stamp; exits
    non-zero where ``device`` is CUDA and there is no card."""
    device = setup(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: CUDA is not available (--device cpu "
                         "runs the plain versions)")
    st = stamp(device)
    print(f"card: {st['card']}; torch {st['torch']}", flush=True)
    return device


def _row(metric, value, vs_baseline=None) -> None:
    print(json.dumps({"metric": metric, "value": round(value, 1),
                      "unit": "particle-steps/s",
                      "vs_baseline": vs_baseline}), flush=True)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--particles", type=int, default=16384)
    # m = 125 makes n_lin = 3 + m = 128, one padded tile of the kernel paths
    ap.add_argument("--basis", type=int, default=125)
    ap.add_argument("--steps", type=int, default=192)
    ap.add_argument("--cov-dtype", default="bfloat16",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--engine", default="rbpf", choices=["rbpf", "pf"],
                    help="pf = gridded terrain PF (1M-particle path)")
    ap.add_argument("--symmetrize", action="store_true",
                    help="re-symmetrize P every step (the reference filter "
                         "does not)")
    ap.add_argument("--ess", type=float, default=1.0,
                    help="ESS resampling threshold (1.0 = every step, the "
                         "reference semantics)")
    ap.add_argument("--kf-kernel", default="lowrank",
                    choices=["xla", "block_gather", "lowrank"],
                    help="KF measurement update: xla (plain torch), "
                         "block_gather (kernel K5) or lowrank (the factored "
                         "carry, kernels K1-K3)")
    ap.add_argument("--lowrank-period", type=int, default=8,
                    help="rebase period r for --kf-kernel lowrank")
    ap.add_argument("--profile", default=None, metavar="LOGDIR",
                    help="write a torch.profiler trace of the headline "
                         "row to LOGDIR")
    ap.add_argument("--skip-pf", action="store_true",
                    help="skip the terrain-PF row")
    ap.add_argument("--skip-extras", action="store_true",
                    help="skip the reference-scale filter, smoother and "
                         "131k-particle rows")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--extra-out", default=None, metavar="PATH",
                    help="write the extras (bench.py's BENCH_EXTRA.json) "
                         "here")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = start(args.device, "bench")

    if args.quick:
        n_particles, m_basis, n_steps = 128, 32, 64
    else:
        n_particles, m_basis, n_steps = args.particles, args.basis, args.steps

    if args.engine == "pf":
        n_pf = 1_048_576 if args.particles == 16384 else args.particles
        if args.quick:
            n_pf = 4096
        throughput, _ = bench_pf(n_pf, 128 if not args.quick else 32,
                                 device=device)
        _row(f"terrain_pf_particle_steps_per_s[N_P={n_pf}]", throughput)
        return 0

    ctx = (trace_to(args.profile) if args.profile
           else contextlib.nullcontext())
    with ctx:
        throughput, elapsed, T = bench_rbpf(
            m_basis, n_particles, n_steps, cov_dtype=args.cov_dtype,
            symmetrize=args.symmetrize, ess_threshold=args.ess,
            kf_kernel=args.kf_kernel, lowrank_period=args.lowrank_period,
            device=device,
        )

    # the baseline's cost a particle-step does not depend on the particle
    # count (a sequential loop), so it runs at a small one
    baseline_throughput = 1.0 / numpy_baseline_best(m_basis,
                                                    min(n_particles, 64))
    step_s = elapsed / T
    hbm_frac = hbm_fraction(n_particles, m_basis, args.kf_kernel,
                            args.cov_dtype, step_s)
    extras = {
        "rbpf_hbm_roofline_fraction": round(hbm_frac, 3),
        "rbpf_step_ms": round(step_s * 1e3, 3),
    }
    if not args.skip_pf:
        n_pf = 4096 if args.quick else 1_048_576
        pf_throughput, _ = bench_pf(n_pf, 32 if args.quick else 128,
                                    device=device)
        extras["terrain_pf_particle_steps_per_s"] = round(pf_throughput, 1)
        extras["terrain_pf_n_particles"] = n_pf
        _row(f"terrain_pf_particle_steps_per_s[N_P={n_pf}]", pf_throughput)
    if not (args.skip_extras or args.quick):
        ref_tp, _, Tr = bench_rbpf(509, 4096, 192, cov_dtype="float32",
                                   kf_kernel="lowrank", device=device)
        extras["rbpf_refscale_particle_steps_per_s"] = round(ref_tp, 1)
        _row("rbpf_dense_mag_particle_steps_per_s"
             f"[N_P=4096,m=509+3,T={Tr},lowrank-kf-r8,f32,ref-scale]",
             ref_tp)
        ref16_tp, _, _ = bench_rbpf(509, 4096, 192, cov_dtype="bfloat16",
                                    kf_kernel="lowrank", device=device)
        extras["rbpf_refscale_bf16_particle_steps_per_s"] = round(ref16_tp,
                                                                  1)
        _row("rbpf_dense_mag_particle_steps_per_s"
             f"[N_P=4096,m=509+3,T={Tr},lowrank-kf-r8,bf16-cov,ref-scale]",
             ref16_tp)
        ps_tp, _, Ts = bench_rbps_info(device=device)
        extras["rbps_info_particle_steps_per_s"] = round(ps_tp, 1)
        _row(f"rbps_info_particle_steps_per_s[N_P=100,m=512+3,T={Ts},"
             "woodbury]", ps_tp)
        # N_P = 131072 at n_lin 128 without the [T, N, dn] histories
        # (ancestors are still returned): 2.1e9 covariance elements
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        big_tp, _, Tb = bench_rbpf(125, 131072, 192, cov_dtype="bfloat16",
                                   kf_kernel="lowrank",
                                   store_trajectories=False, device=device)
        extras["rbpf_131k_particle_steps_per_s"] = round(big_tp, 1)
        if device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(device)
            extras["rbpf_131k_peak_memory_bytes"] = peak
            print(f"131k row: peak device memory {peak / 2**30:.2f} GiB",
                  file=sys.stderr, flush=True)
        _row("rbpf_dense_mag_particle_steps_per_s"
             f"[N_P=131072,m=125+3,T={Tb},lowrank-kf-r8,bf16-cov,no-traj]",
             big_tp)
    if args.extra_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.extra_out)),
                    exist_ok=True)
        with open(args.extra_out, "w") as f:
            json.dump(extras, f, indent=1)
            f.write("\n")

    _row(
        "rbpf_dense_mag_particle_steps_per_s"
        f"[N_P={n_particles},m={m_basis}+3,T={T}"
        + (",gather-kf" if args.kf_kernel == "block_gather" else "")
        + (f",lowrank-kf-r{args.lowrank_period}"
           if args.kf_kernel == "lowrank" else "")
        + (",bf16-cov" if args.cov_dtype == "bfloat16" else "")
        + ("" if args.symmetrize else ",no-sym")
        + (f",ess={args.ess}" if args.ess < 1.0 else "")
        + f",hbm={hbm_frac:.2f}"
        + "]",
        throughput, round(throughput / baseline_throughput, 2),
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
