"""The dense-mag path and field figure (port of scripts/make_mag_figure.py;
examples/slam-dense-mag/mag-path-field.png): one RBPF run at the
reference's size (N_P=100, m=512, m_sim=2000, seed 1, xla path with
symmetrization), then the estimated field magnitude |C(x) xl| on an 80 x 80
grid at the path's median height, with alpha from sqrt(tr(C P C')), and the
filter's paths beside the truth (mag-trajectories.png).

The run is on the card and writes the arrays; the figures render on the
host from them:

    python -m rbslam_tpu_torch.reproduce.make_mag_figure --arrays mag.npz
    python -m rbslam_tpu_torch.reproduce.make_mag_figure --render mag.npz \\
        --figures results/h100/figures
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..basis.laplace import domain_center
from ..engines import RBPFConfig, run_rbpf
from ..metrics import aligned_position_rmse
from ..workloads.dense_mag import DenseMagConfig, build_from_config
from .common import emit, setup, stamp

CONFIG = DenseMagConfig(n_particles=100, n_sweeps=0, m_basis=512,
                        m_sim=2000, seed=1)
CHUNK = 1600    # grid points a [chunk, 3, n_lin] Jacobian block holds


def compute(cfg: DenseMagConfig = CONFIG, *, device="cuda",
            n_grid: int = 80) -> tuple[dict, dict]:
    """The filter run and the gridded map; returns (result, arrays)."""
    device = setup(device)
    problem, data = build_from_config(
        cfg, torch.Generator().manual_seed(cfg.seed), device=device)
    t0 = time.perf_counter()
    res = run_rbpf(
        *problem.rbpf_args(),
        RBPFConfig(n_particles=cfg.n_particles, resampling=cfg.resampling,
                   symmetrize_cov=True),
        generator=torch.Generator(device=device).manual_seed(cfg.seed),
        device=device)
    filter_s = time.perf_counter() - t0

    pos = np.asarray(data.pos)
    LL = data.LL
    x1t = np.linspace(LL[0][0], LL[1][0], n_grid)
    x2t = np.linspace(LL[0][1], LL[1][1], n_grid)
    X1, X2 = np.meshgrid(x1t, x2t)
    pts = np.stack([X1.ravel(), X2.ravel(),
                    np.full(X1.size, float(np.median(pos[:, 2])))], -1)
    pts = torch.as_tensor(pts - domain_center(LL)[None, :], device=device,
                          dtype=torch.float32)
    mag, std = [], []
    for p in torch.split(pts, CHUNK):
        C = problem.potential.grad_blocks(p)                 # [G, 3, nl]
        mag.append(torch.linalg.norm(C @ res.xl_mean, dim=-1))
        var = ((C @ res.P_mean) * C).sum((-2, -1))
        std.append(torch.sqrt(torch.clamp(var, min=0.0)))
    arrays = {
        "x1t": x1t, "x2t": x2t,
        "mag": torch.cat(mag).cpu().numpy(),
        "std": torch.cat(std).cpu().numpy(),
        "truth": pos[:, :2],
        "traj_mean": res.traj_mean[:, :2].cpu().numpy(),
        "traj_max": res.traj_max[:, :2].cpu().numpy(),
    }
    result = {
        "workload": "slam-dense-mag-figure",
        "n_particles": cfg.n_particles, "m_basis": cfg.m_basis,
        "seed": cfg.seed,
        "rmse_filter_pos": float(aligned_position_rmse(
            data.pos, res.traj_mean[:, :3])),
        "filter_s": filter_s,
        **stamp(device),
    }
    return result, arrays


def render(arrays: dict, out_dir: str) -> list[str]:
    """mag-path-field.png and mag-trajectories.png into ``out_dir``."""
    from ..viz import plot_dense_map, plot_trajectories

    os.makedirs(out_dir, exist_ok=True)
    field = os.path.join(out_dir, "mag-path-field.png")
    plot_dense_map(
        field, arrays["x1t"], arrays["x2t"], arrays["mag"],
        traj=arrays["traj_mean"], uncertainty=arrays["std"],
        title="dense-mag: estimated |B| (alpha = posterior certainty)")
    paths = os.path.join(out_dir, "mag-trajectories.png")
    plot_trajectories(
        paths, truth=arrays["truth"],
        estimates=[arrays["traj_mean"], arrays["traj_max"]],
        labels=["filter weighted mean", "filter max-weight"])
    return [field, paths]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--arrays", default=None, metavar="NPZ",
                    help="run, and write the figure's arrays here")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--render", default=None, metavar="NPZ",
                    help="render from these arrays instead of running")
    ap.add_argument("--figures", default=None, help="directory of the PNGs")
    args = ap.parse_args(argv)
    if args.render is not None:
        if args.figures is None:
            ap.error("--render needs --figures")
        with np.load(args.render) as f:
            for path in render(dict(f), args.figures):
                print("wrote", path)
        return
    if args.arrays is None:
        ap.error("give --arrays (run) or --render (draw)")
    result, arrays = compute(device=args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.arrays)), exist_ok=True)
    np.savez_compressed(args.arrays, **arrays)
    emit(result, args.out)


if __name__ == "__main__":
    main()
