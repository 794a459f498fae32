"""The gridded terrain PF at bench.py:125-195's row, and where its time goes
on the GPU.

    python -m rbslam_tpu_torch.workloads.profile_terrain_pf \
        [--particles 1048576] [--steps 128] [--out profile.txt]

The problem: a curl-free field (theta = (10, 1, 25, 4), m_sim = 512)
drawn on a 192 x 192 grid over [-4, 4]^2 and along a loop test path,
the drawn field as the grid's mean and 0.3 as its variance, the path's
body-frame readings and odometry, and a cloud spread uniformly over the
grid; the filter is the gridded terrain model's PF with systematic
resampling and the ESS gate at 0.5 (the 1M-particle row of bench.py).
The draws come from a generator on the device, seeded.

``main`` runs the filter once to warm up, three times for the best
un-profiled wall time, once under ``torch.cuda.set_sync_debug_mode`` to
count the host-device syncs by call site, then once under
``torch.profiler``: the device busy share, the device operations a step
and the device time by kernel, as ``profile_dense_mag`` reports a dense
filter. Needs a CUDA device; there is no CPU mode.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..data.fields import draw_scalar_potential_field
from ..engines.pf import PFConfig, run_pf_localization
from ..math.quaternions import qinv, qmul
from ..models.terrain import TerrainModel, make_gridded_terrain_model
from .mag_localization import _heading_quats, _quat, _test_loop, default_Q
from .profile_dense_mag import count_syncs, profile_lines, sync_report

THETA = (10.0, 1.0, 25.0, 4.0)
EXTENT = 4.0


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


def build_problem(n_particles: int, n_steps: int, *, device, seed: int = 0,
                  n_grid: int = 192, m_sim: int = 512) -> TerrainPFProblem:
    """bench.py:125-195's terrain PF problem on ``device`` from a generator
    seeded with ``seed``."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    xs = np.linspace(-EXTENT, EXTENT, n_grid)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    grid_pts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], -1)
    path = _test_loop(EXTENT * 0.9, n_steps)
    LLs = np.stack([[-EXTENT - 1, -EXTENT - 1, -1.0],
                    [EXTENT + 1, EXTENT + 1, 1.0]])
    pts = torch.as_tensor(np.concatenate([grid_pts, path]),
                          dtype=torch.float32, device=device)
    d = draw_scalar_potential_field(
        pts, m_sim, LLs, THETA,
        z_w=torch.randn(m_sim + 3, generator=gen, device=device),
        z_n=torch.randn((pts.shape[0], 3), generator=gen, device=device))
    _, Rm = _heading_quats(path)
    quat = _quat(Rm.transpose(0, 2, 1))
    y_body = np.einsum("tij,tj->ti", Rm, d.y[X.size:].cpu().numpy())
    qt = torch.as_tensor(quat)
    u = np.concatenate([np.diff(path, axis=0),
                        qmul(qinv(qt[:-1]), qt[1:]).numpy()], -1)
    xy = (2 * torch.rand((n_particles, 2), generator=gen, device=device)
          - 1) * EXTENT
    init = torch.cat([xy, torch.zeros((n_particles, 1), device=device),
                      torch.as_tensor(quat[0], device=device)
                      .expand(n_particles, 4)], dim=-1)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return TerrainPFProblem(
        mean_grid=d.df[:X.size].reshape(n_grid, n_grid, 3),
        var_grid=torch.full((n_grid, n_grid, 3), 0.3, device=device),
        lo=f32([xs[0], xs[0]]), spacing=f32([xs[1] - xs[0]] * 2),
        sigma2=THETA[3], u=f32(u), y=f32(y_body), init=init,
        Q=default_Q().to(device), dt=0.1, path=f32(path))


def config(n_particles: int) -> PFConfig:
    """bench.py:185's filter: systematic, the ESS gate at 0.5."""
    return PFConfig(n_particles=n_particles, resampling="systematic",
                    ess_threshold=0.5)


def position_error(problem: TerrainPFProblem, res) -> tuple[float, float]:
    """(mean over the last two thirds, mean over the last five steps) of
    the distance between traj_mean and the true path in the plane."""
    err = torch.linalg.vector_norm(res.traj_mean[:, :2]
                                   - problem.path[:, :2], dim=-1)
    T = err.shape[0]
    return float(err[T // 3:].mean()), float(err[-5:].mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--particles", type=int, default=1 << 20)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--out", default=None, help="also write the report here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_terrain_pf needs a CUDA device")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    n, T = args.particles, args.steps
    problem = build_problem(n, T, device=device)
    cfg = config(n)
    gen = torch.Generator(device=device)

    def run(seed):
        gen.manual_seed(seed)
        res = problem.run(cfg, generator=gen)
        torch.cuda.synchronize()
        return res

    res = run(0)
    resampled = sum(not torch.equal(a, torch.arange(n, device=device,
                                                    dtype=a.dtype))
                    for a in res.ancestors)
    err = position_error(problem, res)
    del res
    best = float("inf")
    for seed in (1, 2, 3):
        t0 = time.perf_counter()
        run(seed)
        best = min(best, time.perf_counter() - t0)
    syncs = count_syncs(lambda: run(4))
    lines = [
        f"card: {card}",
        f"config: gridded terrain PF N_P={n} T={T} grid 192x192 m_sim=512, "
        "systematic, ess_threshold=0.5",
        f"resampled steps in the warm-up run: {resampled} of {T - 1}; "
        f"position error after burn-in {err[0]:.4f} m, last 5 steps "
        f"{err[1]:.4f} m",
        f"without the profiler: best of 3 {best * 1e3:.3f} ms "
        f"({best * 1e3 / T:.4f} ms/step, {n * T / best:.1f} "
        "particle-steps/s)",
        *sync_report(syncs, T - 1),
        *profile_lines(lambda: run(5), T),
    ]
    report = "\n".join(lines)
    print(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(report + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
