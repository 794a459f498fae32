"""Sparse visual-SLAM workload (port of rbslam_tpu/workloads/sparse_visual.py;
examples/slam-sparse-visual/).

Reference config (main.m, pfslam.m, psslam.m): 20 landmarks, the 197-step
bean curve, a pinhole camera (f=1.5, fp=0, fw=1); the PF with N_P=100; the
PS with N_K=10, N_P=10; initMapVar=4^2, noiseVar=.1^2, guessMapVar=1^2,
Q=blkdiag(.1^2 I2, .001^2), seed 42; per-particle randomized initial maps
(pfslam.m:91); metrics: the Procrustes path and map RMSE from the map
correspondence (calc_rmses.m).

Run on the GPU:  python -m rbslam_tpu_torch.workloads.sparse_visual --quick
(``--device cpu`` runs on the CPU instead). The data corruption and the
initial maps are drawn on the host from a CPU generator seeded by
``--seed``; the filter and the smoother run on the device from a device
generator with the same seed.
"""

from __future__ import annotations

import argparse
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..data.sparse_visual import load_sparse_visual
from ..engines import RBPFConfig, RBPSConfig, run_rbpf, run_rbps
from ..metrics import map_and_path_rmse
from ..models.pinhole2d import make_pinhole2d_model
from ..viz.plots import require_matplotlib
from .common import Timer, report


@dataclass(frozen=True)
class SparseVisualConfig:
    n_particles_pf: int = 100
    n_particles_ps: int = 10
    n_sweeps: int = 10
    init_map_var: float = 4.0**2
    noise_var: float = 0.1**2
    guess_map_var: float = 1.0**2
    n_shuffle: int = 0
    resampling: str = "multinomial"
    run_filter: bool = True
    run_smoother: bool = True
    seed: int = 42


def build_problem(cfg: SparseVisualConfig, generator: torch.Generator, *,
                  device="cuda", draws=None):
    """The dataset (corrupted with ``generator``'s draws, or ``draws``),
    the model and the filter inputs on ``device``: (data, model, Q, R,
    x0_nonlin)."""
    data = load_sparse_visual(generator, n_shuffle=cfg.n_shuffle,
                              draws=draws, device=device)
    M = data.landmarks.shape[0]
    model = make_pinhole2d_model(data.camera, M)
    Q = torch.diag(torch.tensor([0.1**2, 0.1**2, 0.001**2],
                                device=device))            # pfslam.m:93
    R = cfg.noise_var * torch.eye(M, device=device)
    x0_nonlin = torch.tensor(
        np.concatenate([data.init_pos, [data.init_theta]]),
        dtype=torch.float32, device=device)
    return data, model, Q, R, x0_nonlin


def init_maps(noise, landmarks, guess_var: float) -> torch.Tensor:
    """Per-particle randomized initial maps (pfslam.m:91): the true map
    flattened plus sqrt(guess_var) times the standard normals noise
    [N, 2M]."""
    flat = torch.as_tensor(landmarks.reshape(-1), dtype=torch.float32,
                           device=noise.device)
    return flat[None, :] + float(np.sqrt(guess_var)) * noise


def run(cfg: SparseVisualConfig, *, device="cuda", plot_dir=None,
        video=None, ps_video=None) -> dict:
    """The PF, then the CPF-AS smoother, on the vendored dataset; path and
    map RMSE of each. ``plot_dir``: the PF's landmark map figure;
    ``video`` / ``ps_video``: the PF's per-step and the smoother's
    per-sweep animations (GIF); each needs matplotlib."""
    if plot_dir is not None or video is not None or ps_video is not None:
        require_matplotlib()
    device = torch.device(device)
    data_gen = torch.Generator().manual_seed(cfg.seed)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    data, model, Q, R, x0 = build_problem(cfg, data_gen, device=device)
    truth_map = data.landmarks
    truth_traj = data.ground_truth
    n_lin = model.n_lin
    P0 = cfg.init_map_var * torch.eye(n_lin, device=device)
    out = {
        "workload": "slam-sparse-visual",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_landmarks": int(truth_map.shape[0]),
        "n_steps": int(data.y.shape[0]),
    }

    def maps(n):
        noise = torch.randn((n, n_lin), generator=data_gen).to(device)
        return init_maps(noise, truth_map, cfg.guess_map_var)

    if cfg.run_filter:
        x0_lin = maps(cfg.n_particles_pf)
        with Timer(device) as t_f:
            res = run_rbpf(
                model, data.u, data.y, x0, x0_lin, P0, Q, R, 1.0,
                RBPFConfig(n_particles=cfg.n_particles_pf,
                           resampling=cfg.resampling),
                generator=gen, device=device)
        rmse_path, rmse_map = map_and_path_rmse(
            truth_map, res.xl_mean.reshape(-1, 2), truth_traj, res.traj_mean)
        out["pf"] = {
            "rmse_path": float(rmse_path),
            "rmse_map": float(rmse_map),
            "ess_min": float(res.ess.min()),
            "chol_retries": int(res.chol_retries),
            "time_s": t_f.elapsed,
        }
        if plot_dir is not None or video is not None:
            xl_mean = res.xl_mean.reshape(-1, 2).cpu().numpy()
            traj_mean = res.traj_mean[:, :2].cpu().numpy()
        if plot_dir is not None:
            from ..viz import plot_landmark_map

            os.makedirs(plot_dir, exist_ok=True)
            plot_landmark_map(
                os.path.join(plot_dir, "sparse-visual-pf-map.png"),
                truth_map, xl_mean, traj=traj_mean,
                title="PF landmark map + mean trajectory",
            )
        if video is not None:
            # loop-pf.mp4 analog (plot_visual_slam_progress.m): an offline
            # pass over the stored per-step cloud
            from ..viz.animation import animate_particle_cloud

            n_frames = animate_particle_cloud(
                video, res.xn_hist.cpu().numpy(), traj_mean=traj_mean,
                truth=np.asarray(truth_traj),
                landmarks_true=np.asarray(truth_map),
                landmarks_est=xl_mean,
                title="sparse visual SLAM — PF progress",
            )
            out["pf"]["video"] = {"path": video, "frames": n_frames}

    if cfg.run_smoother:
        x0_lin = maps(cfg.n_particles_ps)
        with Timer(device) as t_s:
            res_s = run_rbps(
                model, data.u, data.y, x0, x0_lin, P0, Q, R, 1.0,
                RBPSConfig(n_particles=cfg.n_particles_ps,
                           n_sweeps=cfg.n_sweeps, resampling=cfg.resampling),
                generator=gen, device=device)
        # mean path and map over sweeps 2..K (psslam.m:126-128)
        xnk = torch.mean(res_s.XNK[1:], dim=0)
        xlk = torch.mean(res_s.XLK[1:], dim=0)
        rmse_path, rmse_map = map_and_path_rmse(
            truth_map, xlk.reshape(-1, 2), truth_traj, xnk)
        out["ps"] = {
            "rmse_path": float(rmse_path),
            "rmse_map": float(rmse_map),
            "chol_retries": int(res_s.chol_retries.sum()),
            "time_s": t_s.elapsed,
        }
        if ps_video is not None:
            # loop-ps.mp4 analog: one frame per CPF-AS sweep showing the
            # sampled trajectory and landmark map (psslam.m:126-136)
            from ..viz.animation import animate_smoother_sweeps

            n_frames = animate_smoother_sweeps(
                ps_video, res_s.XNK[:, :, :2].cpu().numpy(),
                XLK=res_s.XLK.cpu().numpy(), truth=np.asarray(truth_traj),
                landmarks_true=np.asarray(truth_map),
                title="sparse visual SLAM — smoother",
            )
            out["ps"]["video"] = {"path": ps_video, "frames": n_frames}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--particles", type=int, default=100)
    ap.add_argument("--ps-particles", type=int, default=10)
    ap.add_argument("--sweeps", type=int, default=10)
    ap.add_argument("--shuffle", type=int, default=0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--plots", default=None, metavar="DIR")
    ap.add_argument("--video", default=None, metavar="GIF",
                    help="write a PF progress animation "
                         "(loop-pf.mp4 analog) to this .gif path")
    ap.add_argument("--ps-video", default=None, metavar="GIF",
                    help="write a smoother per-sweep animation "
                         "(loop-ps.mp4 analog) to this .gif path")
    args = ap.parse_args(argv)
    cfg = SparseVisualConfig(
        n_particles_pf=20 if args.quick else args.particles,
        n_particles_ps=5 if args.quick else args.ps_particles,
        n_sweeps=2 if args.quick else args.sweeps,
        n_shuffle=args.shuffle,
        seed=args.seed,
    )
    report(run(cfg, device=args.device, plot_dir=args.plots,
               video=args.video, ps_video=args.ps_video))


if __name__ == "__main__":
    main()
