"""The port's reproduction scripts (rbslam_tpu_torch/reproduce/) on the CPU
at tiny sizes: each gives every key of the JAX package's recorded results
file, a ``--disturbances`` split merges bit-equal to the unsplit run, the
vendored radio field is the JAX package's draw, the figures render, and
compare.py passes two draws of one distribution and fails a shift.

The radio field asset is written by this file, which imports JAX:
``python tests/test_torch_reproduce.py`` exports the JAX package's seed-1
field of each reference trajectory to
``rbslam_tpu_torch/data/assets/dense_radio_jax_field.npz``.
"""

import copy
import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from rbslam_tpu.workloads import dense_radio as jdense_radio  # noqa: E402
from rbslam_tpu_torch.reproduce import (  # noqa: E402
    common,
    compare,
    make_line_figures,
    make_mag_figure,
    plot_boxplot,
    run_boxplot,
    run_boxplot_lowrank,
    run_mc,
)
from rbslam_tpu_torch.workloads.dense_mag import DenseMagConfig  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RESULTS = os.path.join(REPO, "results")
TINY_MAG = dict(n_particles=6, n_sweeps=2, m_sim=64, n_laps=1, n_per_lap=12)


def _keys(v):
    """The nested key structure of a result, values dropped."""
    if isinstance(v, dict):
        return {k: _keys(x) for k, x in v.items()}
    return None


def _has_keys(got, ref):
    """Every key of ``ref``, at every depth, is in ``got``."""
    if isinstance(ref, dict):
        return isinstance(got, dict) and all(
            k in got and _has_keys(got[k], x) for k, x in ref.items())
    return True


def _reference(name):
    with open(os.path.join(RESULTS, name)) as f:
        return json.load(f)


def _roundtrip(result, capsys):
    """What ``emit`` prints, parsed back: one JSON line."""
    common.emit(result)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return json.loads(lines[0])


def jax_radio_field(traj_type: str) -> np.ndarray:
    """The field of the JAX package's recorded dense-radio runs: the
    first key split of PRNGKey(seed) through its ``build_problem``
    (rbslam_tpu/workloads/dense_radio.py:142-151)."""
    cfg = jdense_radio.DenseRadioConfig(
        traj_type=traj_type, n_steps=run_mc.N_STEPS[traj_type])
    _, k_data, _, _ = jax.random.split(jax.random.PRNGKey(cfg.seed), 4)
    data, *_ = jdense_radio.build_problem(cfg, k_data)
    return np.asarray(data.field_weights)


def export_field_asset(path=run_mc.FIELD_ASSET):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **{t: jax_radio_field(t)
                                 for t in run_mc.N_STEPS})


@pytest.mark.parametrize("traj_type", sorted(run_mc.N_STEPS))
def test_radio_field_asset_is_the_jax_draw(traj_type):
    field = run_mc.jax_field(traj_type)
    assert field.shape == (2000,) and field.dtype == np.float32
    np.testing.assert_array_equal(field, jax_radio_field(traj_type))


@pytest.fixture(scope="module")
def tiny_radio():
    """run_mc at T=12, N_P=8, m=32, 2 runs, 2 sweeps on the JAX field
    (m_sim 2000), with make_line_figures' arrays collected."""
    cfg = run_mc.config("line_3D", n_mc=2, n_sweeps=2)
    cfg = dataclasses.replace(cfg, n_steps=12, n_particles=8, m_basis=32)
    arrays = make_line_figures.LineArrays(cfg.m_basis)
    return cfg, run_mc.run(cfg, device="cpu", on_run=arrays), arrays


def test_run_mc_gives_the_jax_keys(tiny_radio, capsys):
    cfg, out, _ = tiny_radio
    out = _roundtrip(out, capsys)
    for name in ("dense_radio_line_mc100.json",
                 "dense_radio_square_mc100.json"):
        assert _has_keys(_keys(out), _keys(_reference(name)))
    assert out["card"] == "cpu" and out["field"] == "jax"
    assert np.asarray(out["rmse_filter_all"]).shape == (2, 2)
    assert len(out["rmse_smoother_per_sweep"]) == 2
    final = out["rmse_smoother_final_all"]
    assert len(final) == 2 and np.all(np.isfinite(final))
    assert np.isclose(out["rmse_smoother_final"], np.mean(final))


def test_run_mc_own_field():
    cfg = run_mc.config("line_3D", n_mc=1, n_sweeps=1)
    cfg = dataclasses.replace(cfg, n_steps=8, n_particles=4, m_basis=16,
                              m_sim=64)
    own = run_mc.run(cfg, "own", device="cpu")
    assert own["field"] == "own" and np.isfinite(own["rmse_smoother_final"])
    with pytest.raises(ValueError, match="m_sim"):
        run_mc.run(cfg, "jax", device="cpu")


def test_line_figures_summary_and_render(tiny_radio, tmp_path):
    pytest.importorskip("matplotlib")
    cfg, out, arrays = tiny_radio
    summary = make_line_figures.summary(out)
    assert _has_keys(summary, _reference("line_figures_summary.json"))
    assert summary["rmse_smoother_mean"] == out["rmse_smoother_final"]
    a = arrays.arrays()
    assert a["traj_smoother"].shape == (2, cfg.n_steps, 2)
    assert a["est_smoother"].shape == a["f"].shape == (10000,)
    assert all(np.all(np.isfinite(v)) for v in a.values())
    arrays.save(tmp_path / "line.npz")
    with open(tmp_path / "mc.json", "w") as f:
        json.dump(out, f)
    make_line_figures.main([
        "--mc", str(tmp_path / "mc.json"), "--arrays",
        str(tmp_path / "line.npz"), "--figures", str(tmp_path / "fig"),
        "--summary", str(tmp_path / "summary.json")])
    assert sorted(os.listdir(tmp_path / "fig")) == [
        "line-filter-max.png", "line-filter-mean.png", "line-odometry.png",
        "line-smoother.png"]


@pytest.fixture(scope="module")
def tiny_boxplots():
    """Both boxplot scripts at T=12, N_P=6, m ≤ 32, 2 runs, 2 sweeps,
    o in {0, 10}."""
    xla = replace_cfg(run_boxplot.CONFIG, m_basis=29)
    lowrank = replace_cfg(run_boxplot_lowrank.CONFIG, m_basis=29)
    return {
        "xla": run_boxplot.run(xla, (0.0, 10.0), 2, device="cpu"),
        "lowrank": run_boxplot_lowrank.run(lowrank, (0.0, 10.0), 2,
                                           device="cpu"),
        "xla_cfg": xla,
    }


def replace_cfg(cfg: DenseMagConfig, **kw) -> DenseMagConfig:
    return dataclasses.replace(cfg, **{**TINY_MAG, **kw})


@pytest.mark.parametrize("path,name", [
    ("xla", "dense_mag_boxplot.json"),
    ("lowrank", "dense_mag_boxplot_lowrank.json")])
def test_boxplot_gives_the_jax_keys(tiny_boxplots, path, name, capsys,
                                    tmp_path):
    out = _roundtrip(tiny_boxplots[path], capsys)
    ref = _reference(name)
    ref_raw = {o: ref["raw"]["0.0"] for o in ("0.0", "10.0")}
    ref_rows = {o: ref["rmse_by_disturbance"]["0.0"] for o in ("0.0", "10.0")}
    ref = {**ref, "raw": ref_raw, "rmse_by_disturbance": ref_rows}
    assert _has_keys(_keys(out), _keys(ref))
    assert list(out["raw"]) == ["0.0", "10.0"]
    assert out["card"] == "cpu" and out["n_sim"] == 2
    assert out["nan_runs"] == {o: {"ekf": 0, "pf": 0, "ps": 0}
                               for o in ("0.0", "10.0")}
    assert all(np.all(np.isfinite(v)) for r in out["raw"].values()
               for v in r.values())
    if path == "lowrank":
        assert out["kf_kernel"] == "lowrank" and out["m_basis"] == 29
    pytest.importorskip("matplotlib")
    png = plot_boxplot.render(out, str(tmp_path / "box.png"))
    assert os.path.getsize(png) > 0


def test_boxplot_split_merges_bit_equal(tiny_boxplots, tmp_path, capsys):
    full = tiny_boxplots["xla"]
    cfg = tiny_boxplots["xla_cfg"]
    parts = []
    for i, o in enumerate((10.0, 0.0)):
        parts.append(run_boxplot.run(cfg, (o,), 2, device="cpu"))
        with open(tmp_path / f"part{i}.json", "w") as f:
            json.dump(parts[-1], f)
    for merged in (run_boxplot.merge(parts),
                   _roundtrip_merge(tmp_path, capsys)):
        for key in ("raw", "rmse_by_disturbance", "nan_runs"):
            assert merged[key] == full[key]
            assert list(merged[key]) == ["0.0", "10.0"]
    with pytest.raises(ValueError, match="two parts"):
        run_boxplot.merge([parts[0], parts[0]])
    other = dict(parts[1], m_basis=13)
    with pytest.raises(ValueError, match="m_basis"):
        run_boxplot.merge([parts[0], other])


def _roundtrip_merge(tmp_path, capsys):
    run_boxplot.main(["--merge", str(tmp_path / "part0.json"),
                      str(tmp_path / "part1.json")])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_mag_figure_runs_and_renders(tmp_path):
    cfg = dataclasses.replace(make_mag_figure.CONFIG, **TINY_MAG,
                              m_basis=29)
    result, arrays = make_mag_figure.compute(cfg, device="cpu", n_grid=8)
    assert result["card"] == "cpu" and np.isfinite(result["rmse_filter_pos"])
    assert arrays["mag"].shape == arrays["std"].shape == (64,)
    assert arrays["traj_mean"].shape == (12, 2)
    assert all(np.all(np.isfinite(v)) for v in arrays.values())
    pytest.importorskip("matplotlib")
    written = make_mag_figure.render(arrays, str(tmp_path))
    assert [os.path.basename(p) for p in written] == [
        "mag-path-field.png", "mag-trajectories.png"]


def _synthetic(rng, shift=0.0):
    """Boxplot and radio results drawn as the JAX files' shapes: PF and PS
    around 0.25 m, the EKF around 0.5 m at o = 10; ``shift`` standard
    deviations added to every draw."""
    def draw(mu, sd, n):
        return (rng.normal(mu, sd, n) + shift * sd).tolist()

    raw = {o: {"ekf": draw(0.5 if o == "10.0" else 0.24, 0.05, 20),
               "pf": draw(0.25, 0.03, 20), "ps": draw(0.24, 0.03, 20)}
           for o in ("0.0", "1.0", "5.0", "10.0")}
    radio = {"rmse_filter_all": np.stack([draw(0.05, 0.01, 100),
                                          draw(0.03, 0.01, 100)], 1).tolist(),
             "rmse_smoother_final_all": draw(0.01, 0.002, 100)}
    radio["rmse_smoother_final"] = float(
        np.mean(radio["rmse_smoother_final_all"]))
    return {**{s: {"raw": copy.deepcopy(raw)} for s in compare.BOXPLOTS},
            **{s: copy.deepcopy(radio) for s in compare.RADIO}}


def test_compare_passes_one_distribution_and_fails_a_shift(tmp_path):
    ref = _synthetic(np.random.default_rng(1))
    ref["line_figures_summary"] = {"rmse_smoother_median": float(np.median(
        ref["dense_radio_line_mc100"]["rmse_smoother_final_all"]))}
    same = compare.verdicts(_synthetic(np.random.default_rng(2)), ref)
    assert same["family"] == 28 and same["ok"], [
        v for v in same["mann_whitney"] + same["checks"] if not v["ok"]]
    assert len(same["checks"]) == 2 * 9 + 3
    shifted = compare.verdicts(_synthetic(np.random.default_rng(2), 3.0),
                               ref)
    assert not any(t["ok"] for t in shifted["mann_whitney"])
    assert not any(c["ok"] for c in shifted["checks"]
                   if "interval" in c)
    # a NaN run fails its comparison
    nan = _synthetic(np.random.default_rng(2))
    nan["dense_mag_boxplot"]["raw"]["0.0"]["pf"][3] = float("nan")
    bad = [t["name"] for t in compare.verdicts(nan, ref)["mann_whitney"]
           if not t["ok"]]
    assert bad == ["dense_mag_boxplot o=0.0 pf"]
    # the command line over directories; own-field runs reported aside
    for side, results in (("port", _synthetic(np.random.default_rng(2))),
                          ("ref", ref)):
        os.makedirs(tmp_path / side)
        for stem, d in results.items():
            with open(tmp_path / side / f"{stem}.json", "w") as f:
                json.dump(d, f)
    aside = _synthetic(np.random.default_rng(3))
    for stem in ("dense_radio_line_mc100_own_field",
                 "dense_mag_boxplot_bf16_matmul"):
        with open(tmp_path / "port" / f"{stem}.json", "w") as f:
            json.dump(aside[stem.rsplit("_", 2)[0]], f)
    rc = compare.main(["--port", str(tmp_path / "port"), "--reference",
                       str(tmp_path / "ref"), "--out",
                       str(tmp_path / "verdicts.json")])
    assert rc == 0
    with open(tmp_path / "verdicts.json") as f:
        out = json.load(f)
    assert out["family"] == 28
    assert len(out["reported"]) == 4 + 12 + 9


def test_bf16_matmul_inputs_round_the_product_operands_only():
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(4, 5, 6, generator=g), torch.randn(4, 6, 3, generator=g)
    c = torch.randn(4, 5, 3, generator=g)

    def r(x):
        return x.to(torch.bfloat16).float()

    with common.Bf16MatmulInputs():
        got = [a @ b, torch.matmul(a, b), torch.bmm(a, b),
               torch.einsum("nij,njk->nik", a, b), torch.baddbmm(c, a, b),
               a[0] @ b[0, :, 0], torch.linalg.solve(b[:, :3], c[:, :3])]
    want = r(a) @ r(b)
    for x in got[:4]:
        torch.testing.assert_close(x, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[4], c + want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[5], want[0, :, 0], rtol=1e-6, atol=1e-6)
    assert not torch.allclose(want, a @ b, rtol=1e-6, atol=1e-6)
    # a solve keeps float32
    torch.testing.assert_close(got[6], torch.linalg.solve(b[:, :3], c[:, :3]))


def test_runs_with_bf16_matmul_inputs():
    cfg = replace_cfg(run_boxplot.CONFIG, m_basis=29, n_sweeps=1)
    f32 = run_boxplot.run(cfg, (0.0,), 1, device="cpu")
    bf16 = run_boxplot.run(cfg, (0.0,), 1, device="cpu",
                           bf16_matmul_inputs=True)
    assert (f32["matmul_inputs"], bf16["matmul_inputs"]) == (
        "float32", "bfloat16")
    assert bf16["raw"]["0.0"]["ps"] != f32["raw"]["0.0"]["ps"]
    assert np.all(np.isfinite(bf16["raw"]["0.0"]["ps"]))
    mc = run_mc.config("line_3D", n_mc=1, n_sweeps=1)
    mc = dataclasses.replace(mc, n_steps=8, n_particles=4, m_basis=16)
    out = run_mc.run(mc, device="cpu", bf16_matmul_inputs=True)
    assert out["matmul_inputs"] == "bfloat16"
    assert np.isfinite(out["rmse_smoother_final"])


def test_holm_and_bootstrap():
    assert compare.holm([0.01, 0.04, 0.03, 0.2]) == pytest.approx(
        [0.04, 0.09, 0.09, 0.2])
    x = np.random.default_rng(0).normal(1.0, 0.1, 100)
    lo, hi = compare.bootstrap_interval(x, widen=1.0)
    wlo, whi = compare.bootstrap_interval(x)
    assert lo < x.mean() < hi
    assert np.isclose(whi - wlo, np.sqrt(2) * (hi - lo))
    assert np.isclose(whi + wlo, hi + lo)


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    export_field_asset()
    print("wrote", run_mc.FIELD_ASSET, file=sys.stderr)
