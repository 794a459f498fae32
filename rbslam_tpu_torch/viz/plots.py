"""Offline visualization of framework outputs (port of
rbslam_tpu/viz/plots.py).

The reference plots inside the hot loop via the injected makePlots
callback (src/particleFilter.m:215-217). Here plotting is strictly
offline from arrays copied off the device once, after the run: dense
field maps with uncertainty alpha (tools/imagescalpha.m semantics),
trajectory overlays, landmark maps, and the path-degeneracy figure
(degeneracy-{filter,smoother}.png analogs). Matplotlib with the Agg
backend, imported at first use; every function writes a PNG and returns
the path.
"""

from __future__ import annotations

import numpy as np


def require_matplotlib():
    """Import matplotlib with the Agg backend, or raise an ImportError that
    names what needs it."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the plot and video outputs (--plots, --video, --ps-video) need "
            "matplotlib, and the GIFs also pillow; they are not installed"
        ) from e
    matplotlib.use("Agg")
    return matplotlib


def _plt():
    require_matplotlib()
    import matplotlib.pyplot as plt

    return plt


def plot_dense_map(path, x1t, x2t, field_values, traj=None,
                   uncertainty=None, title="Estimated map"):
    """Field heatmap on the visualization grid; per-pixel alpha from the
    posterior std when given (imagescalpha.m:37-45)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    img = np.asarray(field_values).reshape(len(x2t), len(x1t))
    alpha = None
    if uncertainty is not None:
        u = np.asarray(uncertainty).reshape(len(x2t), len(x1t))
        rng = u.max() - u.min()
        alpha = 1.0 - (u - u.min()) / (rng if rng > 0 else 1.0)
    im = ax.imshow(
        img, origin="lower",
        extent=[x1t[0], x1t[-1], x2t[0], x2t[-1]],
        aspect="equal", alpha=alpha,
    )
    fig.colorbar(im, ax=ax)
    if traj is not None:
        traj = np.asarray(traj)
        ax.plot(traj[:, 0], traj[:, 1], "k-", lw=1.5)
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_trajectories(path, truth=None, estimates=None, labels=None,
                      title="Trajectories"):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    if truth is not None:
        truth = np.asarray(truth)
        ax.plot(truth[:, 0], truth[:, 1], "k-", lw=2, label="ground truth")
    for i, est in enumerate(estimates or []):
        est = np.asarray(est)
        lbl = (labels or [None] * len(estimates))[i]
        ax.plot(est[:, 0], est[:, 1], lw=1.2, label=lbl)
    ax.axis("equal")
    if labels:
        ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_landmark_map(path, truth_landmarks, est_landmarks=None,
                      traj=None, title="Landmark map"):
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 5))
    t = np.asarray(truth_landmarks)
    ax.scatter(t[:, 0], t[:, 1], marker="x", c="k", label="true landmarks")
    if est_landmarks is not None:
        e = np.asarray(est_landmarks)
        ax.scatter(e[:, 0], e[:, 1], marker="o", facecolors="none",
                   edgecolors="tab:blue", label="estimated")
        for a, b in zip(t, e):
            ax.plot([a[0], b[0]], [a[1], b[1]], "-", c="0.7", lw=0.6)
    if traj is not None:
        traj = np.asarray(traj)
        ax.plot(traj[:, 0], traj[:, 1], "g-", lw=1)
    ax.axis("equal")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path


def plot_degeneracy(path, xn_traj_filter, smoother_paths, truth=None):
    """Side-by-side path-degeneracy figure: all reconstructed filter
    trajectory histories (collapsed ancestry) vs the CPF-AS smoother
    samples (diverse)."""
    plt = _plt()
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    xt = np.asarray(xn_traj_filter)          # [T, N_P, >=2]
    for i in range(xt.shape[1]):
        axes[0].plot(xt[:, i, 0], xt[:, i, 1], "-", c="tab:red",
                     alpha=0.15, lw=0.8)
    axes[0].set_title("filter trajectory histories")
    for k, p in enumerate(np.asarray(smoother_paths)):
        axes[1].plot(p[:, 0], p[:, 1], "-", alpha=0.5, lw=1.0)
    axes[1].set_title("smoother samples")
    for ax in axes:
        if truth is not None:
            t = np.asarray(truth)
            ax.plot(t[:, 0], t[:, 1], "k--", lw=1.5)
        ax.axis("equal")
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return path
