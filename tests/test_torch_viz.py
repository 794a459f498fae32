"""The port's viz package (a copy of rbslam_tpu/viz/, NumPy and matplotlib)
and the five workload flags that use it, on the CPU. Mirrors
tests/test_viz.py; the homography equals the JAX package's to 1e-10, and
each flag writes its files at a tiny size. Where matplotlib is missing a
flag raises an ImportError naming it, before any work."""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rbslam_tpu.viz import apply_homography as japply  # noqa: E402
from rbslam_tpu.viz import estimate_homography as jestimate  # noqa: E402
from rbslam_tpu_torch.viz import (  # noqa: E402
    apply_homography,
    estimate_homography,
    plot_degeneracy,
    plot_dense_map,
    plot_landmark_map,
    plot_trajectories,
)
from rbslam_tpu_torch.workloads import dense_radio as DR  # noqa: E402
from rbslam_tpu_torch.workloads import mag_localization as ML  # noqa: E402
from rbslam_tpu_torch.workloads import sparse_visual as SV  # noqa: E402


@pytest.fixture
def mpl():
    return pytest.importorskip("matplotlib")


def test_homography_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    A_true = np.array([[120.0, -30.0, 900.0], [10.0, 140.0, 300.0]])
    c_true = np.array([0.02, 0.01, 1.0])
    src = rng.uniform(-3, 3, (12, 2))
    X = np.concatenate([src, np.ones((12, 1))], axis=1)
    dst = (X @ A_true.T) / (X @ c_true)[:, None]
    A, c = estimate_homography(src, dst)
    np.testing.assert_allclose(apply_homography(A, c, src), dst, atol=1e-5)
    Aj, cj = jestimate(src, dst)
    np.testing.assert_allclose(A, Aj, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(c, cj, rtol=1e-10, atol=1e-10)
    pts = rng.uniform(-3, 3, (7, 2))
    np.testing.assert_allclose(apply_homography(A, c, pts),
                               japply(Aj, cj, pts), rtol=1e-10)


def test_plot_functions_write_pngs(tmp_path, mpl):
    rng = np.random.default_rng(1)
    x1t = np.linspace(-2, 2, 20)
    x2t = np.linspace(-2, 2, 25)
    field = rng.normal(size=20 * 25)
    traj = rng.normal(size=(30, 2))
    paths = [
        plot_dense_map(str(tmp_path / "map.png"), x1t, x2t, field,
                       traj=traj, uncertainty=np.abs(field)),
        plot_trajectories(str(tmp_path / "traj.png"), truth=traj,
                          estimates=[traj + 0.1], labels=["est"]),
        plot_landmark_map(str(tmp_path / "lm.png"), rng.normal(size=(8, 2)),
                          rng.normal(size=(8, 2)), traj),
        plot_degeneracy(str(tmp_path / "degen.png"),
                        rng.normal(size=(30, 10, 2)),
                        rng.normal(size=(4, 30, 2)), truth=traj),
    ]
    for p in paths:
        assert os.path.exists(p) and os.path.getsize(p) > 1000


def test_animations_write_gifs(tmp_path, mpl):
    from rbslam_tpu_torch.viz.animation import (
        animate_particle_cloud,
        animate_smoother_sweeps,
    )

    rng = np.random.default_rng(0)
    T, n_p = 6, 30
    xn_hist = rng.normal(size=(T, n_p, 3)).cumsum(axis=0)
    traj = xn_hist.mean(axis=1)
    out = tmp_path / "cloud.gif"
    n = animate_particle_cloud(
        str(out), xn_hist, traj_mean=traj[:, :2], truth=traj[:, :2],
        landmarks_true=rng.normal(size=(4, 2)),
        landmarks_est=rng.normal(size=(4, 2)),
        background=((-3, 3, -3, 3), rng.random((16, 16))), fps=5)
    assert n == T and out.stat().st_size > 1000
    out = tmp_path / "sweeps.gif"
    n = animate_smoother_sweeps(str(out), rng.normal(size=(3, T, 3)),
                                XLK=rng.normal(size=(3, 8)), truth=traj,
                                landmarks_true=rng.normal(size=(4, 2)))
    assert n == 3 and out.stat().st_size > 1000


TINY_RADIO = DR.DenseRadioConfig(n_steps=12, n_particles=8, n_sweeps=2,
                                 m_basis=16, m_sim=32, with_grid=True)
TINY_LOC = ML.MagLocalizationConfig(n_particles=16, m_basis=16, m_sim=32,
                                    n_test_steps=8, n_map_lines=3,
                                    optimize_hyperparams=False)
TINY_SV = SV.SparseVisualConfig(n_particles_pf=4, n_particles_ps=3,
                                n_sweeps=2)


def _no(cfg, field):
    return dataclasses.replace(cfg, **{field: False})


def test_dense_radio_plots(tmp_path, mpl):
    DR.run(TINY_RADIO, device="cpu", plot_dir=str(tmp_path))
    for kind in ("odometry", "filter", "map", "degeneracy"):
        assert (tmp_path / f"line_3D-{kind}.png").stat().st_size > 1000


def test_mag_localization_video(tmp_path, mpl):
    gif = tmp_path / "loc.gif"
    out = ML.run(TINY_LOC, device="cpu", video=str(gif))
    assert out["pf"]["video"] == {"path": str(gif), "frames": 8}
    assert gif.stat().st_size > 1000


@pytest.mark.parametrize("flag", ["plots", "video", "ps_video"])
def test_sparse_visual_figures(tmp_path, mpl, flag):
    if flag == "plots":
        SV.run(_no(TINY_SV, "run_smoother"), device="cpu",
               plot_dir=str(tmp_path))
        assert (tmp_path / "sparse-visual-pf-map.png").stat().st_size > 1000
        return
    gif = tmp_path / f"{flag}.gif"
    if flag == "video":
        out = SV.run(_no(TINY_SV, "run_smoother"), device="cpu",
                     video=str(gif))["pf"]
        assert out["video"]["frames"] == 197
    else:
        out = SV.run(_no(TINY_SV, "run_filter"), device="cpu",
                     ps_video=str(gif))["ps"]
        assert out["video"]["frames"] == TINY_SV.n_sweeps
    assert gif.stat().st_size > 1000


@pytest.mark.parametrize("entry", ["dense_radio", "mag_localization",
                                   "sparse_visual"])
def test_figure_flags_need_matplotlib(monkeypatch, tmp_path, entry):
    """Without matplotlib a figure flag raises an ImportError naming it
    before any work, and never skips its figure quietly."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    calls = {"dense_radio": lambda: DR.run(TINY_RADIO, device="cpu",
                                           plot_dir=str(tmp_path)),
             "mag_localization": lambda: ML.run(TINY_LOC, device="cpu",
                                                video=str(tmp_path / "a.gif")),
             "sparse_visual": lambda: SV.run(TINY_SV, device="cpu",
                                             ps_video=str(tmp_path / "b.gif"))}
    with pytest.raises(ImportError, match="need matplotlib"):
        calls[entry]()
    assert not any(tmp_path.iterdir())
