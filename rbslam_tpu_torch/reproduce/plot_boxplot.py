"""The dense-mag disturbance boxplot figure (port of scripts/plot_boxplot.py;
examples/slam-dense-mag/main.m:80-123, boxplot-mag.png) from a
``run_boxplot`` or ``run_boxplot_lowrank`` result, on the host:

    python -m rbslam_tpu_torch.reproduce.plot_boxplot \\
        results/h100/dense_mag_boxplot.json results/h100/figures/boxplot-mag.png
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import load

METHODS = (("ekf", "EKF"), ("pf", "RBPF"), ("ps", "RBPS (info form)"))
COLORS = ("#d62728", "#1f77b4", "#2ca02c")


def render(d: dict, out: str) -> str:
    from ..viz.plots import require_matplotlib

    require_matplotlib()
    import matplotlib.pyplot as plt

    raw = d["raw"]
    dists = sorted(raw, key=float)
    fig, ax = plt.subplots(figsize=(8, 4.5))
    width = 0.25
    for j, (m, label) in enumerate(METHODS):
        data = [np.asarray(raw[o][m]) for o in dists]
        pos = [i + (j - 1) * width for i in range(len(dists))]
        bp = ax.boxplot(
            data, positions=pos, widths=width * 0.85, patch_artist=True,
            showfliers=True,
            flierprops=dict(marker=".", markersize=4, alpha=0.6),
        )
        for box in bp["boxes"]:
            box.set_facecolor(COLORS[j])
            box.set_alpha(0.6)
        for med in bp["medians"]:
            med.set_color("black")
        ax.plot([], [], color=COLORS[j], label=label, lw=6, alpha=0.6)
    ax.set_xticks(range(len(dists)))
    ax.set_xticklabels([f"{float(o):g}" for o in dists])
    ax.set_xlabel("constant magnetic disturbance o [uT]")
    ax.set_ylabel("position RMSE [m]")
    # the reference's figure clamps its axis to [0, 0.3] m (main.m:80);
    # keep the whole distribution visible but mark the bound
    ax.axhline(0.3, color="gray", ls=":", lw=1)
    ax.set_ylim(0, None)
    path = d.get("kf_kernel", "xla")
    ax.set_title(
        f"dense-mag: EKF vs RBPF ({path}) vs RBPS under disturbance\n"
        f"nSim={d['n_sim']}, N_P={d['n_particles']}, N_K={d['n_sweeps']}, "
        f"m={d['m_basis']}; {d.get('card', 'cpu')}", fontsize=10)
    ax.legend(loc="upper left")
    fig.tight_layout()
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    fig.savefig(out, dpi=130)
    plt.close(fig)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("result", help="a run_boxplot(_lowrank) JSON")
    ap.add_argument("out", help="the PNG to write")
    args = ap.parse_args(argv)
    print("wrote", render(load(args.result), args.out))


if __name__ == "__main__":
    main()
