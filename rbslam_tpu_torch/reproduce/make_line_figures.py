"""The line_3D figure family of slam-dense-radio (port of
scripts/make_line_figures.py; examples/slam-dense-radio/main.m:55-180): the
nMC runs' paths over the true field (line-odometry.png) and over the first
run's estimated map, with alpha from its posterior std (imagescalpha.m):
filter max-weight, filter weighted mean, smoother's last sweep; and
line_figures_summary.json, the mean and median RMSE over the runs.

The runs are ``run_mc --traj line_3D --arrays NPZ`` on the card (the JAX
script's runs are the same as its run_mc's: same config, same seeds); this
script renders on the host from that .npz and the run's JSON:

    python -m rbslam_tpu_torch.reproduce.make_line_figures \\
        --mc dense_radio_line_mc100.json --arrays line_arrays.npz \\
        --figures results/h100/figures --summary line_figures_summary.json
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..basis import hypercube_basis
from ..basis.laplace import domain_center
from ..data.simulate import _grid_values
from .common import emit, load

PATHS = ("odometry", "traj_max", "traj_mean", "traj_smoother")
MAPS = (("max", "xl_max", "P_max"), ("mean", "xl_mean", "P_mean"))
COLOR = (0 / 255, 93 / 255, 141 / 255)   # the reference's line colour
LIMITS = (-0.7, 0.7, -2.0, 2.0)          # main.m:55 xlim / ylim


class LineArrays:
    """``dense_radio.run``'s ``on_run``: keeps each run's 2-D paths and the
    first run's grid (the true field, and the estimated map's mean and
    variance phi(x)' xl, phi(x)' P phi(x) of the filter's max-weight and
    weighted-mean maps and of the smoother's last sweep), computed on the
    host from the maps copied off the device."""

    def __init__(self, m_basis: int):
        self.m_basis = m_basis
        self.paths = {k: [] for k in PATHS}
        self.grid = {}

    def __call__(self, i_mc, data, problem, res, res_s):
        self.paths["odometry"].append(np.asarray(data.odometry_path[:, :2]))
        self.paths["traj_max"].append(res.traj_max[:, :2].cpu().numpy())
        self.paths["traj_mean"].append(res.traj_mean[:, :2].cpu().numpy())
        self.paths["traj_smoother"].append(
            res_s.XNK[-1, :, :2].cpu().numpy())
        if i_mc:
            return
        weights = torch.as_tensor(data.field_weights, dtype=torch.float32)
        grid = _grid_values(data.LL, weights.shape[0], weights, False)
        X1, X2 = np.meshgrid(grid["x1t"], grid["x2t"])
        pts = np.stack([X1.ravel(), X2.ravel()], -1) \
            - domain_center(data.LL)[None, :2]
        phi = hypercube_basis(self.m_basis, data.LL).phi(
            torch.as_tensor(pts, dtype=torch.float32))
        maps = [(tag, getattr(res, xl), getattr(res, P))
                for tag, xl, P in MAPS]
        maps.append(("smoother", res_s.XLK[-1], res_s.PK[-1]))
        self.grid = {"x1t": grid["x1t"], "x2t": grid["x2t"],
                     "f": grid["f"]}
        for tag, xl, P in maps:
            xl, P = xl.float().cpu(), P.float().cpu()
            self.grid[f"est_{tag}"] = (phi @ xl).numpy()
            self.grid[f"var_{tag}"] = torch.einsum(
                "ni,ij,nj->n", phi, P, phi).numpy()

    def arrays(self) -> dict:
        return {**{k: np.stack(v) for k, v in self.paths.items()},
                **self.grid}

    def save(self, path) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        np.savez_compressed(path, **self.arrays())


def summary(mc: dict) -> dict:
    """The JAX script's summary from a line_3D ``run_mc`` result: the
    filter's weighted-mean RMSE and the smoother's final-sweep RMSE over
    the runs."""
    rf = np.asarray(mc["rmse_filter_all"])[:, 1]
    rs = np.asarray(mc["rmse_smoother_final_all"])
    return {
        "n_mc": mc["n_mc"], "n_sweeps": mc["n_sweeps"],
        "rmse_filter_mean": float(rf.mean()),
        "rmse_filter_median": float(np.median(rf)),
        "rmse_smoother_mean": float(rs.mean()),
        "rmse_smoother_median": float(np.median(rs)),
        "wall_s": mc["wall_s"],
        "field": mc["field"], "card": mc["card"], "torch": mc["torch"],
    }


def _alpha(var, shape):
    u = np.sqrt(np.maximum(var, 0.0)).reshape(shape)
    span = u.max() - u.min()
    return 1.0 - (u - u.min()) / (span if span > 0 else 1.0)


def render(arrays: dict, out_dir: str, n_sweeps: int) -> list[str]:
    """The four PNGs of the JAX script into ``out_dir``; returns their
    paths."""
    from ..viz.plots import require_matplotlib

    require_matplotlib()
    import matplotlib.pyplot as plt

    x1t, x2t = arrays["x1t"], arrays["x2t"]
    shape = (len(x2t), len(x1t))
    n_mc = arrays["odometry"].shape[0]
    os.makedirs(out_dir, exist_ok=True)
    panels = [
        ("line-odometry.png", arrays["f"], None, "odometry",
         f"odometry ({n_mc} MC runs), true field"),
        ("line-filter-max.png", arrays["est_max"],
         _alpha(arrays["var_max"], shape), "traj_max", "filter max-weight"),
        ("line-filter-mean.png", arrays["est_mean"],
         _alpha(arrays["var_mean"], shape), "traj_mean",
         "filter weighted mean"),
        ("line-smoother.png", arrays["est_smoother"],
         _alpha(arrays["var_smoother"], shape), "traj_smoother",
         f"smoother (sweep {n_sweeps})"),
    ]
    written = []
    for name, img, alpha, paths, title in panels:
        fig, ax = plt.subplots(figsize=(4.2, 6))
        ax.imshow(np.asarray(img).reshape(shape), origin="lower",
                  extent=[x1t[0], x1t[-1], x2t[0], x2t[-1]], aspect="equal",
                  alpha=alpha, cmap="viridis")
        for tr in arrays[paths]:
            ax.plot(tr[:, 0], tr[:, 1], "-", color=COLOR, lw=0.8)
        ax.set_xlim(LIMITS[:2])
        ax.set_ylim(LIMITS[2:])
        ax.set_xticks([])
        ax.set_yticks([])
        ax.set_title(title, fontsize=10)
        fig.tight_layout()
        path = os.path.join(out_dir, name)
        fig.savefig(path, dpi=130)
        plt.close(fig)
        written.append(path)
    return written


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mc", required=True,
                    help="the line_3D run_mc result (JSON)")
    ap.add_argument("--arrays", required=True,
                    help="that run's --arrays .npz")
    ap.add_argument("--figures", required=True, help="directory of the PNGs")
    ap.add_argument("--summary", default=None,
                    help="also write the summary JSON here")
    args = ap.parse_args(argv)
    mc = load(args.mc)
    if mc["traj_type"] != "line_3D":
        raise ValueError(f"{args.mc} is a {mc['traj_type']} run, not line_3D")
    with np.load(args.arrays) as f:
        arrays = dict(f)
    for path in render(arrays, args.figures, mc["n_sweeps"]):
        print("wrote", path)
    emit(summary(mc), args.summary)


if __name__ == "__main__":
    main()
