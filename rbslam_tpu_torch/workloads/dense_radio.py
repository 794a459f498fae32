"""Dense radio-SLAM workload (port of rbslam_tpu/workloads/dense_radio.py;
examples/slam-dense-radio/).

Reference configs: line_3D (N_T=32, heading-noise spike 0.3^2 at t=N/2)
and the square_3D degeneracy demo (N_T=48, 0.1^2 spikes at the three
corners) (run_dense2D_withHeading.m:64-91); theta=[0.25;2;0.01], m=128
estimation basis (:108), N_P=100 (:165), N_K sweeps of the smoother, nMC
Monte Carlo repetitions reusing the same field with fresh odometry and
measurement noise (main.m:24-27, :156-161).

Run on the GPU:  python -m rbslam_tpu_torch.workloads.dense_radio --quick
(``--device cpu`` runs the kernels' plain versions instead). ``--plots DIR``
writes the figures (needs matplotlib).
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..basis import hypercube_basis, se_spectral_density
from ..basis.laplace import domain_center
from ..data import DenseDataset, simulate_dense_dataset
from ..engines import (
    RBPFConfig,
    RBPSConfig,
    run_rbpf,
    run_rbps,
    run_rbps_information_form,
)
from ..metrics import aligned_position_rmse
from ..models import make_radio2d_model
from ..utils.interop import Problem, radio_problem_from_numpy
from ..viz.plots import require_matplotlib
from .common import Timer, report


@dataclass(frozen=True)
class DenseRadioConfig:
    traj_type: str = "line_3D"      # or "square_3D" (degeneracy demo)
    theta: tuple = (0.25, 2.0, 0.01)
    n_steps: int = 32               # 48 for square_3D
    n_particles: int = 100
    n_sweeps: int = 20
    n_mc: int = 1
    m_basis: int = 128
    m_sim: int = 2000
    resampling: str = "multinomial"
    smoother: str = "cpf_as"        # or "info_form"
    seed: int = 1
    with_grid: bool = False         # the dataset's visualization grid


def _process_noise(cfg: DenseRadioConfig) -> torch.Tensor:
    """Heading process-noise spikes (run_dense2D_withHeading.m:65-91):
    Q [T-1, 1, 1] float32."""
    n = cfg.n_steps
    Qvec = 1e-6 * np.ones(n)
    if cfg.traj_type == "line_3D":
        Qvec[n // 2 - 1] = 0.3**2
    elif cfg.traj_type == "square_3D":
        for j in range(3):
            Qvec[n // 4 * (j + 1) - 1] = 0.1**2
    else:
        raise ValueError(f"unsupported traj_type {cfg.traj_type!r}")
    return torch.as_tensor(Qvec[: n - 1].reshape(-1, 1, 1),
                           dtype=torch.float32)


def build_problem(cfg: DenseRadioConfig, generator: torch.Generator,
                  field_weights=None, *,
                  device) -> tuple[Problem, DenseDataset]:
    """Simulate one dataset on the host from ``generator`` (a CPU
    generator) and build the m_basis-function radio2d model and the
    filter/smoother inputs on ``device``. Returns (problem, dataset)."""
    Q = _process_noise(cfg)
    gen_model = make_radio2d_model(
        hypercube_basis(4, np.array([1.0, 1.0])), device="cpu")
    data = simulate_dense_dataset(
        cfg.traj_type, cfg.theta, Q, 1.0, gen_model.dynamics,
        m_sim=cfg.m_sim, traj_kwargs={"n": cfg.n_steps},
        field_weights=field_weights, with_grid=cfg.with_grid,
        generator=generator,
    )
    basis = hypercube_basis(cfg.m_basis, data.LL)
    k = se_spectral_density(
        torch.as_tensor(np.sqrt(basis.eigenvalues), dtype=torch.float32),
        cfg.theta[0], cfg.theta[1], 2,
    )
    problem = radio_problem_from_numpy(
        basis.NN, basis.L, basis.eigenvalues,
        domain_center(data.LL).astype(np.float32), k.numpy(), Q.numpy(),
        np.array([[cfg.theta[2]]]), 1.0, data.dx.numpy(), data.y.numpy(),
        data.init_state.numpy(), device=device,
    )
    return problem, data


def _make_plots(plot_dir, cfg, data, problem, res, res_s):
    """Figure-family analogs of the reference's committed PNGs
    (line-odometry / line-filter-{max,mean} / line-smoother / degeneracy-*;
    README.md:85-119). The map and its posterior std on the grid use the
    model's Jacobian rows phi(x) (K6 on the card); every array then comes
    off the device once."""
    from ..viz import plot_degeneracy, plot_dense_map, plot_trajectories

    out = {"traj_max": res.traj_max[:, :2], "traj_mean": res.traj_mean[:, :2],
           "xn_traj": res.xn_traj[:, :, :2]}
    if res_s is not None:
        out["XNK"] = res_s.XNK[:, :, :2]
    if data.grid is not None:
        X1, X2 = np.meshgrid(data.grid["x1t"], data.grid["x2t"])
        xn = torch.tensor(np.stack([X1.ravel(), X2.ravel(),
                                    np.zeros(X1.size)], -1),
                          dtype=torch.float32, device=res.xl_mean.device)
        Phi = problem.model.meas_jacobian_batch(xn)[:, 0, :]
        out["est"] = Phi @ res.xl_mean
        out["var"] = torch.einsum("ni,ij,nj->n", Phi, res.P_mean, Phi)
    out = {k: v.cpu().numpy() for k, v in out.items()}

    os.makedirs(plot_dir, exist_ok=True)
    tag = cfg.traj_type
    plot_trajectories(
        os.path.join(plot_dir, f"{tag}-odometry.png"),
        truth=data.pos, estimates=[data.odometry_path[:, :2]],
        labels=["odometry (dead reckoning)"],
        title="True trajectory vs odometry",
    )
    plot_trajectories(
        os.path.join(plot_dir, f"{tag}-filter.png"),
        truth=data.pos, estimates=[out["traj_max"], out["traj_mean"]],
        labels=["filter max-weight", "filter weighted mean"],
        title="Filter trajectories",
    )
    if data.grid is not None:
        plot_dense_map(
            os.path.join(plot_dir, f"{tag}-map.png"),
            data.grid["x1t"], data.grid["x2t"], out["est"],
            traj=out["traj_mean"],
            uncertainty=np.sqrt(np.maximum(out["var"], 0.0)),
            title="Estimated field map (alpha = posterior std)",
        )
    if res_s is not None:
        plot_degeneracy(
            os.path.join(plot_dir, f"{tag}-degeneracy.png"),
            out["xn_traj"], out["XNK"], truth=data.pos,
        )


def run(cfg: DenseRadioConfig, *, device, plot_dir=None,
        field_weights=None, on_run=None) -> dict:
    """Filter, then ``cfg.n_sweeps`` smoother sweeps, ``cfg.n_mc`` times on
    one field; Procrustes-aligned position RMSE of each. ``plot_dir``: write
    the first repetition's figures there (needs matplotlib; the dataset then
    gets its grid, which draws nothing). ``field_weights`` [m_sim]: the
    field of every repetition (by default the first one draws it).
    ``on_run(i_mc, data, problem, res, res_s)`` is called after each
    repetition (``res_s`` None without sweeps). Beside the JAX package's
    keys, ``rmse_smoother_final_all`` keeps each repetition's final-sweep
    RMSE."""
    if plot_dir is not None:
        require_matplotlib()
        cfg = replace(cfg, with_grid=True)
    device = torch.device(device)
    data_gen = torch.Generator().manual_seed(cfg.seed)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    rmse_filter, rmse_smoother, times = [], [], {}
    for i_mc in range(cfg.n_mc):
        problem, data = build_problem(cfg, data_gen, field_weights,
                                      device=device)
        field_weights = data.field_weights

        with Timer(device) as t_f:
            res = run_rbpf(
                *problem.rbpf_args(),
                RBPFConfig(n_particles=cfg.n_particles,
                           resampling=cfg.resampling),
                generator=gen, device=device,
            )
        times.setdefault("filter_s", []).append(t_f.elapsed)
        rmse_filter.append([
            float(aligned_position_rmse(data.pos, res.traj_max[:, :2])),
            float(aligned_position_rmse(data.pos, res.traj_mean[:, :2])),
        ])

        res_s = None
        if cfg.n_sweeps > 0:
            smoother = (run_rbps_information_form
                        if cfg.smoother == "info_form" else run_rbps)
            with Timer(device) as t_s:
                res_s = smoother(
                    *problem.rbpf_args(),
                    RBPSConfig(n_particles=cfg.n_particles,
                               n_sweeps=cfg.n_sweeps,
                               resampling=cfg.resampling),
                    generator=gen, device=device,
                )
            times.setdefault("smoother_s", []).append(t_s.elapsed)
            rmse_smoother.append([
                float(aligned_position_rmse(data.pos, res_s.XNK[s, :, :2]))
                for s in range(cfg.n_sweeps)
            ])

        if plot_dir is not None and i_mc == 0:
            _make_plots(plot_dir, cfg, data, problem, res, res_s)
        if on_run is not None:
            on_run(i_mc, data, problem, res, res_s)

    rf = np.asarray(rmse_filter)
    out = {
        "workload": "slam-dense-radio",
        "traj_type": cfg.traj_type,
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_mc": cfg.n_mc,
        "rmse_filter_max_mean": rf.mean(0).tolist(),
        "rmse_filter_all": rf.tolist(),
        "times_s": {k_: float(np.mean(v)) for k_, v in times.items()},
    }
    if rmse_smoother:
        rs = np.asarray(rmse_smoother)
        out["rmse_smoother_per_sweep"] = rs.mean(0).tolist()
        out["rmse_smoother_final"] = float(rs[:, -1].mean())
        out["rmse_smoother_final_all"] = rs[:, -1].tolist()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--traj", default="line_3D",
                    choices=["line_3D", "square_3D"])
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--sweeps", type=int, default=20)
    ap.add_argument("--mc", type=int, default=1)
    ap.add_argument("--basis", type=int, default=128)
    ap.add_argument("--resampling", default="multinomial")
    ap.add_argument("--smoother", default="cpf_as",
                    choices=["cpf_as", "info_form"])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="reduced config for smoke runs")
    ap.add_argument("--plots", default=None, metavar="DIR",
                    help="write figure PNGs (maps, trajectories, degeneracy)")
    args = ap.parse_args(argv)
    cfg = DenseRadioConfig(
        traj_type=args.traj,
        n_steps=48 if args.traj == "square_3D" else 32,
        n_particles=20 if args.quick else args.particles,
        n_sweeps=3 if args.quick else args.sweeps,
        n_mc=args.mc,
        m_basis=32 if args.quick else args.basis,
        m_sim=256 if args.quick else 2000,
        resampling=args.resampling,
        smoother=args.smoother,
        seed=args.seed,
    )
    report(run(cfg, device=args.device, plot_dir=args.plots))


if __name__ == "__main__":
    main()
