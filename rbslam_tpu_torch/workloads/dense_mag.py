"""Dense 3D magnetic-field SLAM workload (port of
rbslam_tpu/workloads/dense_mag.py and bench.py::_build_problem;
examples/slam-dense-mag/).

Reference config (run_dense3D_magfield.m, main.m): bean_6D trajectory
(N_T=192), dt=0.01, Q = blkdiag(10^2 diag[.05^2,.05^2,.01^2],
diag([.01 .01 .3] deg)^2), theta=[650;1.2;200;10], m=512(+3 linear)
basis functions, N_P=100, N_K=10, constant magnetic disturbance o added
to the measurements (main.m:37-60), EKF baseline (ekf_dense.m), metrics:
Procrustes position RMSE + quaternion-error orientation RMSE.

Run on the GPU:  python -m rbslam_tpu_torch.workloads.dense_mag --quick
(``--device cpu`` runs the kernels' plain versions instead; ``--compare``
runs the disturbance sweep). The JAX CLI's ``--pallas-basis`` has no
counterpart: on a CUDA device the port's mag3d model always evaluates its
Jacobians through the basis kernels.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..basis import hypercube_basis
from ..basis.laplace import domain_center
from ..basis.spectral import linear_plus_se_spectral
from ..data import DenseDataset, simulate_dense_dataset
from ..engines import (
    RBPFConfig,
    RBPSConfig,
    run_ekf_dense,
    run_ekf_dense_batched,
    run_rbpf,
    run_rbps,
    run_rbps_information_form,
)
from ..metrics import aligned_position_rmse, orientation_rmse_deg, rms
from ..models.mag3d import dynamics_with_increment
from ..utils.interop import Problem, ekf_inputs, problem_from_numpy
from .common import Timer, report

THETA = (650.0, 1.2, 200.0, 10.0)
DT = 0.01


def default_Q() -> torch.Tensor:
    """main.m:22: blkdiag(10^2 diag[.05,.05,.01].^2, diag([.01 .01 .3]deg).^2)."""
    qpos = 10.0**2 * np.array([0.05**2, 0.05**2, 0.01**2])
    qori = (np.array([0.01, 0.01, 0.3]) * np.pi / 180.0) ** 2
    return torch.as_tensor(np.diag(np.concatenate([qpos, qori])),
                           dtype=torch.float32)


@dataclass(frozen=True)
class DenseMagConfig:
    theta: tuple = THETA
    n_particles: int = 100
    n_sweeps: int = 10
    m_basis: int = 512
    m_sim: int = 2000
    dt: float = DT
    mag_disturbance: tuple = (0.0, 0.0, 0.0)   # constant offset o (main.m:40)
    n_laps: int = 3
    n_per_lap: int = 64
    resampling: str = "multinomial"
    smoother: str = "info_form"
    run_ekf: bool = True
    run_filter: bool = True
    seed: int = 1
    cov_dtype: str = "float32"
    symmetrize_cov: bool = True
    ancestor_form: str = "woodbury"
    kf_kernel: str = "xla"      # RBPFConfig.kf_kernel of the filter


def build_from_config(cfg: DenseMagConfig, generator: torch.Generator, *,
                      device) -> tuple[Problem, DenseDataset]:
    """Simulate one bean_6D dataset on the host from ``generator`` (a CPU
    generator), add the constant disturbance to its measurements, and build
    the m_basis-function mag3d model and the filter inputs on ``device``.
    Returns (problem, dataset); ``problem.y`` carries the disturbance."""
    Q = default_Q()
    data = simulate_dense_dataset(
        "bean_6D", cfg.theta, Q, cfg.dt, dynamics_with_increment,
        m_sim=cfg.m_sim,
        traj_kwargs={"n_laps": cfg.n_laps, "n_per_lap": cfg.n_per_lap},
        with_grid=False, generator=generator,
    )
    y = data.y + torch.as_tensor(cfg.mag_disturbance, dtype=data.y.dtype)
    basis = hypercube_basis(cfg.m_basis, data.LL)
    k = linear_plus_se_spectral(
        torch.as_tensor(np.sqrt(basis.eigenvalues), dtype=torch.float32),
        cfg.theta[0], cfg.theta[1], cfg.theta[2], 3,
    )
    problem = problem_from_numpy(
        basis.NN, basis.L, basis.eigenvalues,
        domain_center(data.LL).astype(np.float32), k.numpy(), Q.numpy(),
        cfg.theta[3] * np.eye(3), cfg.dt, data.dx.numpy(), y.numpy(),
        data.init_state.numpy(), device=device,
    )
    return problem, data


def build_problem(m_basis: int, n_steps: int, seed: int = 1,
                  m_sim: int = 512, *,
                  device) -> tuple[Problem, DenseDataset]:
    """The flagship filtering problem: a bean_6D dataset of ``n_steps``
    steps (laps of 64, as the benchmark builds it) simulated on the host
    from ``seed`` with an m_sim-function field, and an m_basis-function
    filter model on ``device``. Returns (problem, dataset)."""
    n_laps = max(1, n_steps // 64)
    cfg = DenseMagConfig(m_basis=m_basis, m_sim=m_sim, n_laps=n_laps,
                         n_per_lap=n_steps // n_laps)
    return build_from_config(cfg, torch.Generator().manual_seed(seed),
                             device=device)


def run(cfg: DenseMagConfig, _built=None, *, device="cuda",
        generator: torch.Generator | None = None) -> dict:
    """Filter, ``cfg.n_sweeps`` smoother sweeps and the EKF baseline on one
    dataset; position and orientation RMSE of each. ``generator`` (on
    ``device``) supplies the filter's and the smoother's draws; by default
    it is seeded with ``cfg.seed``, as the dataset's host generator is."""
    device = torch.device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    problem, data = _built if _built is not None else build_from_config(
        cfg, torch.Generator().manual_seed(cfg.seed), device=device)
    out = {
        "workload": "slam-dense-mag",
        "mag_disturbance": list(cfg.mag_disturbance),
        "n_steps": int(problem.y.shape[0]),
    }

    def ori_rmse(quat):
        return float(rms(orientation_rmse_deg(data.quat, quat)))

    if cfg.run_filter:
        with Timer(device) as t_f:
            res = run_rbpf(
                *problem.rbpf_args(),
                RBPFConfig(
                    n_particles=cfg.n_particles, resampling=cfg.resampling,
                    cov_dtype=cfg.cov_dtype,
                    symmetrize_cov=cfg.symmetrize_cov,
                    kf_kernel=cfg.kf_kernel,
                ),
                generator=generator, device=device,
            )
        out["rmse_filter_pos"] = [
            float(aligned_position_rmse(data.pos, res.traj_max[:, :3])),
            float(aligned_position_rmse(data.pos, res.traj_mean[:, :3])),
        ]
        out["rmse_filter_ori_deg"] = [ori_rmse(res.traj_max[:, 3:7]),
                                      ori_rmse(res.traj_mean[:, 3:7])]
        out["filter_s"] = t_f.elapsed
        out["filter_ess_min"] = float(res.ess.min())

    if cfg.n_sweeps > 0:
        smoother = (run_rbps_information_form
                    if cfg.smoother == "info_form" else run_rbps)
        with Timer(device) as t_s:
            res_s = smoother(
                *problem.rbpf_args(),
                RBPSConfig(
                    n_particles=cfg.n_particles, n_sweeps=cfg.n_sweeps,
                    resampling=cfg.resampling, cov_dtype=cfg.cov_dtype,
                    symmetrize_cov=cfg.symmetrize_cov,
                    ancestor_form=cfg.ancestor_form,
                ),
                generator=generator, device=device,
            )
        out["rmse_smoother_pos"] = [
            float(aligned_position_rmse(data.pos, res_s.XNK[s, :, :3]))
            for s in range(cfg.n_sweeps)
        ]
        out["rmse_smoother_ori_deg"] = [
            ori_rmse(res_s.XNK[s, :, 3:7]) for s in range(cfg.n_sweeps)
        ]
        out["smoother_s"] = t_s.elapsed

    if cfg.run_ekf:
        x0, q0, P0 = ekf_inputs(problem, domain_center(data.LL))
        with Timer(device) as t_e:
            res_e = run_ekf_dense(
                problem.potential, problem.dx, problem.y, x0, q0, P0,
                problem.Q, problem.R, cfg.dt, device=device)
        out["rmse_ekf_pos"] = float(
            aligned_position_rmse(data.pos, res_e.x_traj[:, :3]))
        out["ekf_s"] = t_e.elapsed

    return out


def run_comparison(cfg: DenseMagConfig, disturbances=(0.0, 1.0, 5.0, 10.0),
                   n_sim: int = 20, *, device="cuda",
                   generator: torch.Generator | None = None) -> dict:
    """EKF vs PF vs PS RMSE distributions under constant disturbances: the
    reference's boxplot experiment (main.m:37-60, boxplot-mag.png). The
    n_sim EKF runs of each disturbance level are one batch
    (run_ekf_dense_batched); the PF and PS runs stay sequential (they are
    batched over particles). Beside the position RMSEs, ``raw`` keeps the
    filter's and the smoother's orientation RMSE per run (``pf_ori_deg``,
    ``ps_ori_deg``). Run i simulates its dataset from ``cfg.seed + i``;
    ``generator`` (on ``device``) supplies the draws of every PF and PS run
    in turn; by default each run draws from a generator seeded with its
    own ``cfg.seed + i``."""
    device = torch.device(device)
    rows, raw = {}, {}
    for o in disturbances:
        pf, ps, pf_ori, ps_ori, builds = [], [], [], [], []
        for i in range(n_sim):
            cfg_i = replace(cfg, mag_disturbance=(0.0, float(o), 0.0),
                            seed=cfg.seed + i, run_ekf=False)
            built = build_from_config(
                cfg_i, torch.Generator().manual_seed(cfg_i.seed),
                device=device)
            builds.append(built)
            r = run(cfg_i, _built=built, device=device, generator=generator)
            pf.append(r["rmse_filter_pos"][1])            # weighted mean
            ps.append(r["rmse_smoother_pos"][-1])         # final sweep
            pf_ori.append(r["rmse_filter_ori_deg"][1])
            ps_ori.append(r["rmse_smoother_ori_deg"][-1])

        # batched EKF over the n_sim runs of this disturbance level
        problem0, data0 = builds[0]
        x0, q0, P0 = ekf_inputs(problem0, domain_center(data0.LL))
        res_e = run_ekf_dense_batched(
            problem0.potential,
            torch.stack([b[0].dx for b in builds]),
            torch.stack([b[0].y for b in builds]),
            x0, q0, P0, problem0.Q, problem0.R, cfg.dt, device=device)
        ekf = [
            float(aligned_position_rmse(builds[i][1].pos,
                                        res_e.x_traj[i, :, :3]))
            for i in range(n_sim)
        ]

        key_o = str(float(o))
        raw[key_o] = {"ekf": ekf, "pf": pf, "ps": ps,
                      "pf_ori_deg": pf_ori, "ps_ori_deg": ps_ori}
        rows[key_o] = {
            name: {
                "mean": float(np.mean(v)),
                "median": float(np.median(v)),
                "max": float(np.max(v)),
            }
            for name, v in (("ekf", ekf), ("pf", pf), ("ps", ps))
        }
    return {"workload": "slam-dense-mag-comparison", "n_sim": n_sim,
            "n_particles": cfg.n_particles, "n_sweeps": cfg.n_sweeps,
            "m_basis": cfg.m_basis, "ancestor_form": cfg.ancestor_form,
            "rmse_by_disturbance": rows, "raw": raw}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--compare", action="store_true",
                    help="disturbance-sweep EKF/PF/PS comparison (main.m:37-60)")
    ap.add_argument("--nsim", type=int, default=20)
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--basis", type=int, default=512)
    ap.add_argument("--disturbance", type=float, default=0.0,
                    help="constant y-axis offset o in {0,1,5,10} (main.m:40)")
    ap.add_argument("--smoother", default="info_form",
                    choices=["cpf_as", "info_form"])
    ap.add_argument("--no-ekf", action="store_true")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cov-dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="covariance/information storage dtype")
    ap.add_argument("--no-symmetrize", action="store_true",
                    help="skip the per-step covariance re-symmetrization "
                         "pass (the reference filter's own semantics)")
    ap.add_argument("--ancestor-form", default="woodbury",
                    choices=["cholesky", "woodbury"],
                    help="info-form ancestor weights: per-step nl^3 "
                         "factorization vs rank-ny inverse maintenance")
    ap.add_argument("--kf-kernel", default="xla",
                    choices=["xla", "block_gather", "lowrank"],
                    help="filter KF update path; 'lowrank' (factored "
                         "carry) needs no per-step symmetrization")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg = DenseMagConfig(
        n_particles=10 if args.quick else args.particles,
        n_sweeps=2 if args.quick else args.sweeps,
        m_basis=64 if args.quick else args.basis,
        m_sim=256 if args.quick else 2000,
        mag_disturbance=(0.0, args.disturbance, 0.0),
        n_laps=1 if args.quick else 3,
        smoother=args.smoother,
        run_ekf=not args.no_ekf,
        seed=args.seed,
        cov_dtype=args.cov_dtype,
        symmetrize_cov=not args.no_symmetrize,
        ancestor_form=args.ancestor_form,
        kf_kernel=args.kf_kernel,
    )
    if args.compare:
        report(run_comparison(
            cfg,
            disturbances=(0.0, 1.0) if args.quick else (0.0, 1.0, 5.0, 10.0),
            n_sim=2 if args.quick else args.nsim,
            device=args.device,
        ))
    else:
        report(run(cfg, device=args.device))


if __name__ == "__main__":
    main()
