"""Magnetic mapping + terrain-matching localization workload (port of
rbslam_tpu/workloads/mag_localization.py; examples/mag-localization-mapping/).

Reference pipeline (main.m, run_localization.m): train a scalar-potential
GP magnetic map (m=1000 basis functions) from mapping-phase data, then run
a plain particle filter (N_P=1000) that localizes a test path on the
fixed map; particles start uniformly over the domain (:156-161), and the
dynamics compose odometry increments with noise (:274-281).

The reference uses the external AaltoML/magnetic-data robot dataset
(README.md:66-71). Without a local copy this workload generates an
equivalent synthetic environment (a drawn curl-free field, a lawnmower
mapping path and a loop test path), labelled as such in the output.

Run on the GPU:  python -m rbslam_tpu_torch.workloads.mag_localization --quick
(``--device cpu`` runs on the CPU instead). The synthetic field and the
initial cloud are drawn on the host from a CPU generator seeded by
``--seed``; the GP fit and the filter run on the device.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from ..data.fields import draw_scalar_potential_field
from ..engines.pf import PFConfig, run_pf_localization
from ..gp import fit_scalar_potential_gp
from ..math.quaternions import qinv, qmul, rmat_to_quat
from ..models.terrain import make_terrain_model
from ..viz.plots import require_matplotlib
from .common import Timer, report


@dataclass(frozen=True)
class MagLocalizationConfig:
    # run_localization.m:30 hyperparameters fitted to the real robot data,
    # used with --data; the synthetic environment uses a length scale a
    # practical basis resolves over its domain
    theta: tuple = (500.0, 0.1178, 384.659, 3.5859)
    synthetic_theta: tuple = (10.0, 1.0, 25.0, 4.0)
    n_particles: int = 1000
    m_basis: int = 1000
    m_sim: int = 2000
    dt: float = 0.1
    # the reference ML-II-optimizes the hyperparameters (main.m:117)
    optimize_hyperparams: bool = True
    weight_mode: str = "product"      # "sum" reproduces the reference quirk
    resampling: str = "systematic"
    ess_threshold: float = 0.5
    data_path: Optional[str] = None   # AaltoML magnetic-data, if present
    seed: int = 1
    extent: float = 4.0               # synthetic domain half-size [m]
    n_map_lines: int = 11             # lawnmower passes
    n_test_steps: int = 160


def default_Q() -> torch.Tensor:
    """run_localization.m:28: blkdiag(4^2 (0.01)^2 I3, (1e-2 deg)^2 I3),
    float32 on the CPU."""
    qpos = 4.0**2 * 0.01**2 * np.ones(3)
    qori = (1e-2 * np.pi / 180.0) ** 2 * np.ones(3)
    return torch.as_tensor(np.diag(np.concatenate([qpos, qori])),
                           dtype=torch.float32)


def _lawnmower(extent, n_lines, pts_per_line=40):
    xs = np.linspace(-extent, extent, n_lines)
    rows = []
    for i, x in enumerate(xs):
        ys = np.linspace(-extent, extent, pts_per_line)
        if i % 2:
            ys = ys[::-1]
        rows.append(np.stack([np.full_like(ys, x), ys], -1))
    path = np.concatenate(rows, 0)
    return np.concatenate([path, np.zeros((len(path), 1))], -1)


def _test_loop(extent, n_steps):
    t = np.linspace(0, 2 * np.pi, n_steps)
    r = 0.6 * extent
    return np.stack([r * np.cos(t), 0.7 * r * np.sin(2 * t),
                     np.zeros_like(t)], -1)


def _heading_quats(path):
    """Body-from-navigation rotations R [T, 3, 3] of a path's heading and
    their quaternions [T, 4] (float32 numpy)."""
    d = np.diff(path[:, :2], axis=0)
    psi = np.arctan2(d[:, 1], d[:, 0])
    psi = np.append(psi, psi[-1])
    R = np.zeros((len(psi), 3, 3))
    R[:, 0, 0] = np.cos(psi)
    R[:, 0, 1] = np.sin(psi)
    R[:, 1, 0] = -np.sin(psi)
    R[:, 1, 1] = np.cos(psi)
    R[:, 2, 2] = 1.0
    return _quat(R), R


def _quat(R) -> np.ndarray:
    return rmat_to_quat(torch.as_tensor(R, dtype=torch.float32)).numpy()


def _load_real_data(path, sensor="invensense"):
    """Load the AaltoML magnetic-data robot dataset.

    Accepts either the cloned dataset repository root (the layout
    main.m:27-60 reads: ``<root>/data/<sensor>/{i}-loc.csv`` and
    ``{i}-mag.csv`` for segments i = 1..9; loc = [n, 2] positions, mag =
    [n, 3] field), concatenated with segment ids as the reference does, or
    a ``.mat`` file with pre-concatenated ``x [n,2], y [n,3], s [n]``.
    Returns (x [n, 2], y [n, 3], s [n] int segment ids).
    """
    if os.path.isdir(path):
        base = os.path.join(path, "data", sensor)
        xs, ys, ss = [], [], []
        for i in range(1, 10):
            loc = np.loadtxt(os.path.join(base, f"{i}-loc.csv"),
                             delimiter=",")
            mag = np.loadtxt(os.path.join(base, f"{i}-mag.csv"),
                             delimiter=",")
            xs.append(np.atleast_2d(loc)[:, :2])
            ys.append(np.atleast_2d(mag)[:, :3])
            ss.append(np.full(len(xs[-1]), i))
        return np.concatenate(xs), np.concatenate(ys), np.concatenate(ss)
    import scipy.io as sio

    d = sio.loadmat(path)
    return d["x"], d["y"], d["s"].ravel()


def _environment(cfg: MagLocalizationConfig, gen: torch.Generator):
    """(x_train, y_train, x_test, y_test_nav, data label) as float64
    numpy: the real dataset's segments when ``cfg.data_path`` exists,
    else the synthetic environment drawn from ``gen``."""
    if cfg.data_path and os.path.exists(cfg.data_path):
        x_all, y_all, s = _load_real_data(cfg.data_path)
        train = (s < 3) | (s == 4)
        x_train = np.concatenate(
            [x_all[train], np.zeros((train.sum(), 1))], -1)[::10]
        y_train = y_all[train][::10]
        test = s == 3
        x_test = np.concatenate(
            [x_all[test], np.zeros((test.sum(), 1))], -1)[::50]
        return x_train, y_train, x_test, y_all[test][::50], \
            "aaltoml-magnetic-data"
    x_train = _lawnmower(cfg.extent, cfg.n_map_lines)
    x_test = _test_loop(cfg.extent, cfg.n_test_steps)
    pad = 0.5
    LL_sim = np.stack([[-cfg.extent - pad, -cfg.extent - pad, -1.0],
                       [cfg.extent + pad, cfg.extent + pad, 1.0]])
    draw = draw_scalar_potential_field(
        torch.as_tensor(np.concatenate([x_train, x_test]),
                        dtype=torch.float32),
        cfg.m_sim, LL_sim, cfg.theta, generator=gen)
    y = draw.y.numpy()
    return x_train, y[:len(x_train)], x_test, y[len(x_train):], "synthetic"


def run(cfg: MagLocalizationConfig, *, device="cuda", video=None) -> dict:
    """Map, then localize: the GP fit on the mapping data and its map error
    on the test path, then the PF from a uniform initial cloud. ``video``:
    write the localization animation (robot-pf.mp4 analog) to this GIF
    (needs matplotlib and pillow)."""
    if video is not None:
        require_matplotlib()
    device = torch.device(device)
    data_gen = torch.Generator().manual_seed(cfg.seed)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    if not (cfg.data_path and os.path.exists(cfg.data_path)):
        cfg = replace(cfg, theta=cfg.synthetic_theta)
    x_train, y_train, x_test, y_test_nav, label = _environment(cfg, data_gen)
    out = {"workload": "mag-localization-mapping", "data": label,
           "device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu")}

    # --- mapping phase: fit the GP magnetic map ---
    lo = x_train.min(0)
    hi = x_train.max(0)
    rng = hi - lo
    pad = 0.2 * np.min(rng[rng > 0])
    LL = np.stack([lo - pad, hi + pad])
    with Timer(device) as t_fit:
        gp = fit_scalar_potential_gp(
            x_train, y_train, cfg.m_basis, LL, cfg.theta,
            optimize=cfg.optimize_hyperparams, device=device)
    out["gp"] = {"nll": gp.nll, "theta": [float(v) for v in gp.theta],
                 "fit_s": t_fit.elapsed}
    mean_test, _ = gp.predict_gradient(x_test)
    y_test_t = torch.as_tensor(y_test_nav, dtype=torch.float32,
                               device=device)
    out["gp"]["test_rmse"] = float(
        torch.sqrt(torch.mean((mean_test - y_test_t) ** 2)))

    # --- localization phase ---
    _, R = _heading_quats(x_test)
    # R is body-from-nav; the model predicts quat_to_rmat(q)^T @ mean_nav,
    # so q represents nav-from-body = R^T (generateData_dense.m:252-257)
    quat = _quat(R.transpose(0, 2, 1))
    y_body = np.einsum("tij,tj->ti", R, y_test_nav)
    dpos = np.diff(x_test, axis=0)
    qt = torch.as_tensor(quat)
    dquat = qmul(qinv(qt[:-1]), qt[1:]).numpy()
    u = np.concatenate([dpos, dquat], -1)

    # the model works in the GP's centered frame
    model = make_terrain_model(gp.potential, gp.mean_weights, gp.chol,
                               float(gp.theta[3]), mode=cfg.weight_mode,
                               center=gp.center)

    # particles spread uniformly over the training area (:156-161)
    n_p = cfg.n_particles
    init = np.tile(np.concatenate([x_test[0], quat[0]]), (n_p, 1)) \
        .astype(np.float32)
    for j in (0, 1):
        init[:, j] = (lo[j] + (hi[j] - lo[j])
                      * torch.rand(n_p, generator=data_gen).numpy())

    with Timer(device) as t_pf:
        res = run_pf_localization(
            model.dynamics, model.log_weight, u, y_body, init, default_Q(),
            cfg.dt,
            PFConfig(n_particles=n_p, resampling=cfg.resampling,
                     ess_threshold=cfg.ess_threshold,
                     store_trajectories=video is not None),
            n_noise=model.n_noise, generator=gen, device=device)
    T = y_body.shape[0]
    err = np.linalg.norm(res.traj_mean[:, :2].cpu().numpy() - x_test[:, :2],
                         axis=-1)
    burn = T // 3
    out["pf"] = {
        "n_particles": n_p,
        "mean_err_after_burnin": float(err[burn:].mean()),
        "final_err": float(err[-5:].mean()),
        "ess_min": float(res.ess.min()),
        "time_s": t_pf.elapsed,
        "particle_steps_per_s": n_p * T / t_pf.elapsed,
    }
    if video is not None:
        # global localization converging on the GP magnetic map, rendered
        # offline from the stored cloud: |mean field| on a 60 x 60 grid
        from ..viz.animation import animate_particle_cloud

        n_grid = 60
        GX, GY = np.meshgrid(np.linspace(lo[0], hi[0], n_grid),
                             np.linspace(lo[1], hi[1], n_grid))
        pts = np.stack([GX.ravel(), GY.ravel(), np.zeros(GX.size)], -1)
        mean_g, _ = gp.predict_gradient(pts)
        img = torch.linalg.norm(mean_g, dim=-1).reshape(n_grid, n_grid)
        n_frames = animate_particle_cloud(
            video, res.xn_hist.cpu().numpy(),
            traj_mean=res.traj_mean[:, :2].cpu().numpy(),
            truth=x_test[:, :2],
            background=((lo[0], hi[0], lo[1], hi[1]), img.cpu().numpy()),
            title="magnetic terrain localization — PF",
        )
        out["pf"]["video"] = {"path": video, "frames": n_frames}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--particles", type=int, default=1000)
    ap.add_argument("--basis", type=int, default=1000)
    ap.add_argument("--no-optimize", action="store_true",
                    help="skip ML-II hyperparameter optimization (the "
                         "reference optimizes by default, main.m:117)")
    ap.add_argument("--weight-mode", default="product",
                    choices=["product", "sum"])
    ap.add_argument("--data", default=None,
                    help="AaltoML magnetic-data: the cloned dataset "
                         "repository root (data/<sensor>/*.csv) or a "
                         "pre-converted .mat")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--video", default=None, metavar="GIF",
                    help="write a localization animation "
                         "(robot-pf.mp4 analog) to this .gif path")
    args = ap.parse_args(argv)
    cfg = MagLocalizationConfig(
        n_particles=200 if args.quick else args.particles,
        m_basis=256 if args.quick else args.basis,
        m_sim=512 if args.quick else 2000,
        n_test_steps=60 if args.quick else 160,
        optimize_hyperparams=not (args.no_optimize or args.quick),
        weight_mode=args.weight_mode,
        data_path=args.data,
        seed=args.seed,
    )
    report(run(cfg, device=args.device, video=args.video))


if __name__ == "__main__":
    main()
