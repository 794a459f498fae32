"""Progress animations, GIF analogs of the reference's MP4 outputs (port
of rbslam_tpu/viz/animation.py).

The reference renders per-step videos by calling a plotting callback
INSIDE the filter loop (`makePlots`, src/particleFilter.m:215-217;
examples/mag-localization-mapping robot-pf.mp4 / loop-pf.mp4;
examples/slam-sparse-visual/plot_visual_slam_progress.m). Here the
engines return the per-step particle cloud (`xn_hist`) and the estimate
trajectories, and animation is an OFFLINE pass over arrays copied off the
device once: the filter never waits on matplotlib. GIFs via PillowWriter
(no ffmpeg dependency).
"""

from __future__ import annotations

import numpy as np

from .plots import require_matplotlib


def _writer(fps):
    from matplotlib.animation import PillowWriter

    return PillowWriter(fps=fps)


def animate_particle_cloud(
    out_path: str,
    xn_hist,                 # [T, N_P, >=2] per-step particle states
    traj_mean=None,          # [T, >=2] estimate trajectory
    truth=None,              # [T, >=2] ground-truth positions
    background=None,         # optional (extent, image [H, W(, 3)])
    landmarks_true=None,     # [M, 2]
    landmarks_est=None,      # [M, 2] final estimates (fade in over time)
    max_particles: int = 400,
    fps: int = 10,
    stride: int = 1,
    title: str = "particle filter",
    dpi: int = 80,
):
    """Render the per-step particle cloud + growing estimate trajectory
    to an animated GIF (robot-pf.mp4 / loop-pf.mp4 analog). Returns the
    number of frames written."""
    require_matplotlib()
    import matplotlib.pyplot as plt

    xn_hist = np.asarray(xn_hist)
    T = xn_hist.shape[0]
    n_show = min(max_particles, xn_hist.shape[1])
    frames = list(range(0, T, stride))

    fig, ax = plt.subplots(figsize=(6, 6))
    if background is not None:
        extent, img = background
        ax.imshow(np.asarray(img), origin="lower", extent=extent,
                  alpha=0.7, cmap="viridis", zorder=0)
    all_xy = xn_hist[:, :, :2].reshape(-1, 2)
    lo, hi = all_xy.min(0), all_xy.max(0)
    pad = 0.05 * (hi - lo + 1e-9)
    ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
    ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
    ax.set_aspect("equal")
    ax.set_title(title)

    if truth is not None:
        truth = np.asarray(truth)
        ax.plot(truth[:, 0], truth[:, 1], "k--", lw=1, alpha=0.6,
                label="truth", zorder=1)
    if landmarks_true is not None:
        lm = np.asarray(landmarks_true)
        ax.plot(lm[:, 0], lm[:, 1], "k*", ms=10, zorder=2,
                label="landmarks")
    lm_sc = None
    if landmarks_est is not None:
        lm_e = np.asarray(landmarks_est)
        lm_sc = ax.plot([], [], "r+", ms=9, zorder=3,
                        label="landmark est")[0]
    cloud = ax.scatter(
        xn_hist[0, :n_show, 0], xn_hist[0, :n_show, 1],
        s=4, c="tab:blue", alpha=0.4, zorder=4, label="particles",
    )
    est_line = None
    if traj_mean is not None:
        traj_mean = np.asarray(traj_mean)
        est_line = ax.plot([], [], "r-", lw=1.5, zorder=5,
                           label="estimate")[0]
    ax.legend(loc="upper right", fontsize=8)

    writer = _writer(fps)
    with writer.saving(fig, out_path, dpi):
        for t in frames:
            cloud.set_offsets(xn_hist[t, :n_show, :2])
            if est_line is not None:
                est_line.set_data(traj_mean[: t + 1, 0],
                                  traj_mean[: t + 1, 1])
            if lm_sc is not None and t >= T // 2:
                lm_sc.set_data(lm_e[:, 0], lm_e[:, 1])
            writer.grab_frame()
    import matplotlib.pyplot as plt  # noqa: F811

    plt.close(fig)
    return len(frames)


def animate_smoother_sweeps(
    out_path: str,
    XNK,                     # [N_K, T, >=2] sampled trajectory per sweep
    XLK=None,                # [N_K, 2M] sampled landmark map per sweep
    truth=None,              # [T, >=2] ground-truth positions
    landmarks_true=None,     # [M, 2]
    fps: int = 2,
    title: str = "smoother progress",
    dpi: int = 80,
):
    """Render the CPF-AS smoother's per-sweep sampled trajectory (and
    landmark map) as an animated GIF — the `loop-ps.mp4` analog
    (examples/slam-sparse-visual/psslam.m + plot_visual_slam_progress.m,
    one frame per Gibbs sweep k instead of per time step). Offline pass
    over the returned (XNK, XLK) arrays; the sweeps never block on the
    renderer. Returns the number of frames written."""
    require_matplotlib()
    import matplotlib.pyplot as plt

    XNK = np.asarray(XNK)
    n_k = XNK.shape[0]

    fig, ax = plt.subplots(figsize=(6, 6))
    all_xy = XNK[:, :, :2].reshape(-1, 2)
    if truth is not None:
        all_xy = np.concatenate([all_xy, np.asarray(truth)[:, :2]], 0)
    lo, hi = all_xy.min(0), all_xy.max(0)
    pad = 0.08 * (hi - lo + 1e-9)
    ax.set_xlim(lo[0] - pad[0], hi[0] + pad[0])
    ax.set_ylim(lo[1] - pad[1], hi[1] + pad[1])
    ax.set_aspect("equal")

    if truth is not None:
        truth = np.asarray(truth)
        ax.plot(truth[:, 0], truth[:, 1], "k--", lw=1, alpha=0.6,
                label="truth", zorder=1)
    if landmarks_true is not None:
        lm = np.asarray(landmarks_true)
        ax.plot(lm[:, 0], lm[:, 1], "k*", ms=10, zorder=2,
                label="landmarks")
    prev_lines = []
    cur_line = ax.plot([], [], "r-", lw=1.8, zorder=5,
                       label="sampled trajectory")[0]
    lm_sc = None
    if XLK is not None:
        XLK = np.asarray(XLK)
        lm_sc = ax.plot([], [], "r+", ms=9, zorder=4,
                        label="landmark sample")[0]
    ax.legend(loc="upper right", fontsize=8)

    writer = _writer(fps)
    with writer.saving(fig, out_path, dpi):
        for k in range(n_k):
            # past sweeps stay as faded history (degeneracy-vs-diversity
            # is the point of the figure family)
            if k > 0:
                faded = ax.plot(XNK[k - 1, :, 0], XNK[k - 1, :, 1], "-",
                                color="tab:orange", lw=0.8, alpha=0.35,
                                zorder=3)[0]
                prev_lines.append(faded)
            cur_line.set_data(XNK[k, :, 0], XNK[k, :, 1])
            if lm_sc is not None:
                lm_k = XLK[k].reshape(-1, 2)
                lm_sc.set_data(lm_k[:, 0], lm_k[:, 1])
            ax.set_title(f"{title} — sweep {k + 1}/{n_k}")
            writer.grab_frame()
    plt.close(fig)
    return n_k
