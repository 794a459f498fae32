"""The dense-mag workload of the port, its kernel-part profile and its
lowrank accuracy gate, on the CPU at the ``--quick`` size.

The port draws its data and noise from torch generators, so the numbers
differ from the JAX package's; what is held to the JAX package here is
the output's layout (every key of the JAX ``run`` and ``run_comparison``
at the same size, the same types and lengths) and the shared pieces the
workload is built from (the config's defaults, default_Q, report).
"""

import dataclasses
import json
import math
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rbslam_tpu.workloads import dense_mag as jdense_mag  # noqa: E402
from rbslam_tpu_torch.workloads import (  # noqa: E402
    check_lowrank_flagship,
    check_smoother_bf16,
    common,
    dense_mag,
    profile_kernel_parts,
)

QUICK = dict(n_particles=10, n_sweeps=2, m_basis=64, m_sim=256, n_laps=1)


def _finite(v):
    if isinstance(v, (list, tuple)):
        return all(_finite(x) for x in v)
    if isinstance(v, dict):
        return all(_finite(x) for x in v.values())
    return not isinstance(v, float) or math.isfinite(v)


def _layout(v):
    """Types and lengths of a result, values dropped."""
    if isinstance(v, dict):
        return {k: _layout(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_layout(x) for x in v]
    return type(v).__name__


@pytest.fixture(scope="module")
def quick_run():
    return dense_mag.run(dense_mag.DenseMagConfig(**QUICK), device="cpu")


def test_config_matches_jax_defaults():
    port = dataclasses.asdict(dense_mag.DenseMagConfig())
    ref = dataclasses.asdict(jdense_mag.DenseMagConfig())
    assert ref.pop("pallas_basis") is False      # no counterpart in the port
    assert port == ref
    np.testing.assert_allclose(dense_mag.default_Q().numpy(),
                               np.asarray(jdense_mag.default_Q()), rtol=1e-6)


def test_run_gives_the_jax_keys(quick_run):
    ref = jdense_mag.run(jdense_mag.DenseMagConfig(**QUICK))
    assert list(quick_run) == list(ref)
    assert _layout(quick_run) == _layout(ref)
    assert _finite(quick_run)
    assert quick_run["n_steps"] == 64
    # accuracy at this size: the same order as the JAX package's run
    assert quick_run["rmse_filter_pos"][1] < 2 * ref["rmse_filter_pos"][1] + 0.3
    assert max(quick_run["rmse_filter_ori_deg"]) < 2.0
    assert quick_run["rmse_ekf_pos"] < 1.0


@pytest.mark.parametrize("smoother", ["info_form", "cpf_as"])
@pytest.mark.parametrize("kf_kernel", ["xla", "lowrank", "block_gather"])
def test_run_options(smoother, kf_kernel):
    cfg = dense_mag.DenseMagConfig(
        **{**QUICK, "n_particles": 6, "m_basis": 13, "m_sim": 32,
           "n_per_lap": 12},
        smoother=smoother, kf_kernel=kf_kernel, run_ekf=False,
        symmetrize_cov=kf_kernel == "xla", mag_disturbance=(0.0, 5.0, 0.0))
    out = dense_mag.run(cfg, device="cpu")
    assert "rmse_ekf_pos" not in out and out["n_steps"] == 12
    assert len(out["rmse_smoother_pos"]) == 2 and _finite(out)
    assert out["mag_disturbance"] == [0.0, 5.0, 0.0]


def test_run_is_reproducible_and_takes_a_generator(quick_run):
    cfg = dense_mag.DenseMagConfig(**QUICK, run_ekf=False)
    again = dense_mag.run(cfg, device="cpu")
    assert again["rmse_smoother_pos"] == quick_run["rmse_smoother_pos"]
    other = dense_mag.run(cfg, device="cpu",
                          generator=torch.Generator().manual_seed(99))
    assert other["rmse_filter_pos"] != quick_run["rmse_filter_pos"]


def test_disturbance_enters_the_measurements_only():
    cfg = dense_mag.DenseMagConfig(**QUICK)
    gen = torch.Generator().manual_seed(3)
    clean, data = dense_mag.build_from_config(cfg, gen, device="cpu")
    gen.manual_seed(3)
    cfg_o = dataclasses.replace(cfg, mag_disturbance=(0.0, 10.0, 0.0))
    shifted, _ = dense_mag.build_from_config(cfg_o, gen, device="cpu")
    assert torch.equal(shifted.y, clean.y + torch.tensor([0.0, 10.0, 0.0]))
    assert torch.equal(shifted.dx, clean.dx)
    assert torch.equal(clean.y, data.y)


def test_comparison_gives_the_jax_keys_and_keeps_orientation():
    cfg = dense_mag.DenseMagConfig(**QUICK)
    out = dense_mag.run_comparison(cfg, disturbances=(0.0, 1.0), n_sim=2,
                                   device="cpu")
    ref = jdense_mag.run_comparison(jdense_mag.DenseMagConfig(**QUICK),
                                    disturbances=(0.0, 1.0), n_sim=2)
    assert list(out) == list(ref)
    for o in ("0.0", "1.0"):
        extra = {"pf_ori_deg", "ps_ori_deg"}
        assert set(out["raw"][o]) == set(ref["raw"][o]) | extra
        for k in extra:
            out_k = out["raw"][o].pop(k)
            assert len(out_k) == 2 and _finite(out_k)
    assert _layout(out) == _layout(ref)
    assert _finite(out)
    # the first run of the sweep is the run of the same seed alone
    alone = dense_mag.run(dataclasses.replace(cfg, run_ekf=False),
                          device="cpu")
    assert out["raw"]["0.0"]["pf"][0] == alone["rmse_filter_pos"][1]
    assert out["raw"]["0.0"]["ps"][0] == alone["rmse_smoother_pos"][-1]


def test_workloads_take_an_explicit_generator():
    """A generator seeded as the default one reproduces the default's first
    run; the later runs go on drawing from it."""
    cfg = dense_mag.DenseMagConfig(**QUICK)
    kw = dict(disturbances=(0.0,), n_sim=2, device="cpu")
    default = dense_mag.run_comparison(cfg, **kw)["raw"]["0.0"]
    given = dense_mag.run_comparison(
        cfg, generator=torch.Generator().manual_seed(cfg.seed),
        **kw)["raw"]["0.0"]
    assert given["pf"][0] == default["pf"][0]
    assert given["ps"][0] == default["ps"][0]
    assert given["pf"][1] != default["pf"][1]
    assert given["ekf"] == default["ekf"]

    kw = dict(device="cpu", m_basis=13, n_particles=8, n_laps=1, m_sim=32)
    default = check_lowrank_flagship.run(2, **kw)["rows"][0]["rmse"]
    given = check_lowrank_flagship.run(
        2, generator=torch.Generator().manual_seed(100), **kw)["rows"][0]["rmse"]
    assert given[0] == default[0] and given[1] != default[1]


def test_cli_quick(capsys):
    dense_mag.main(["--quick", "--device", "cpu", "--no-ekf",
                    "--kf-kernel", "lowrank", "--no-symmetrize",
                    "--disturbance", "1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["workload"] == "slam-dense-mag"
    assert out["mag_disturbance"] == [0.0, 1.0, 0.0]
    assert "rmse_ekf_pos" not in out


def test_report_cleans_tensors_and_arrays(capsys):
    common.report({"a": torch.tensor(1.5), "b": np.arange(2),
                   "c": [np.float32(2.0), {"d": torch.ones(2)}]})
    assert json.loads(capsys.readouterr().out) == {
        "a": 1.5, "b": [0, 1], "c": [2.0, {"d": [1.0, 1.0]}]}
    with common.Timer("cpu") as t:
        pass
    assert t.elapsed >= 0
    assert common.config_dict(dense_mag.DenseMagConfig())["m_basis"] == 512


def test_profile_kernel_parts_on_cpu():
    """Every probe and K2, K3, K5 run once through their plain versions;
    no time is reported off the card; bounds follow the distinct indices."""
    out = profile_kernel_parts.run("cpu", (16, 13, "bfloat16"), reps=2)
    assert out["device"] == "cpu" and out["nl"] == 128
    rows = out["rows"]
    assert len(rows) == 3 * 8 + 3
    assert all(r["ms"] is None and r["tb_per_s"] is None for r in rows)
    assert all(r["bound_ms"] > 0 for r in rows)
    assert {r["bound_by"] for r in rows} <= {"bytes", "operations"}
    assert profile_kernel_parts.bound_ms(3.35e9, 0, torch.float32) \
        == (1.0, "bytes")
    assert profile_kernel_parts.bound_ms(0, 67e9, torch.float32) \
        == (1.0, "operations")
    by = {(r["kernel"], r["pattern"]): r for r in rows}
    ident = by[("probe_gather (K10)", "identity")]
    syst = by[("probe_gather (K10)", "systematic")]
    assert ident["unique_indices"] == 16 >= syst["unique_indices"] >= 1
    assert syst["bytes"] <= ident["bytes"]
    assert set(out["decomposition"]) == {"identity", "sorted_random",
                                         "systematic"}
    profile_kernel_parts.print_table(out)


def test_index_patterns():
    g = torch.Generator().manual_seed(0)
    pats = profile_kernel_parts.index_patterns(64, g, "cpu")
    for name, idx in pats.items():
        assert idx.dtype == torch.int32 and idx.shape == (64,), name
        assert bool((idx[1:] >= idx[:-1]).all()), name
        assert 0 <= int(idx.min()) and int(idx.max()) < 64
    assert torch.equal(pats["identity"], torch.arange(64, dtype=torch.int32))
    assert int(torch.unique(pats["systematic"]).numel()) < 64


def test_check_lowrank_flagship_small():
    out = check_lowrank_flagship.run(2, device="cpu", m_basis=13,
                                     n_particles=8, n_laps=1, m_sim=32)
    assert [(r["kf_kernel"], r["symmetrize_cov"], r["cov_dtype"])
            for r in out["rows"]] == list(check_lowrank_flagship.ROWS)
    for r in out["rows"]:
        assert len(r["rmse"]) == 2 and r["n_nan"] == 0
        assert r["rmse_median"] <= r["rmse_max"] < 1.0
    # f32 lowrank without symmetrization follows the xla path with it
    lo, xla = out["rows"][0], out["rows"][1]
    np.testing.assert_allclose(lo["rmse"], xla["rmse"], atol=5e-3)


def test_check_smoother_bf16_small(capsys, monkeypatch):
    out = check_smoother_bf16.run(2, device="cpu", m_basis=13,
                                  n_particles=8, n_sweeps=2, n_laps=1,
                                  m_sim=32)
    assert [r["cov_dtype"] for r in out["rows"]] == list(
        check_smoother_bf16.DTYPES)
    for r in out["rows"]:
        assert len(r["rmse"]) == 2 and r["n_nan"] == 0
        assert r["rmse_median"] <= r["rmse_max"] < 1.0
    f32, bf16 = out["rows"]
    assert f32["rmse"] != bf16["rmse"]
    # the command line passes the seed count and the dtypes through
    calls = []
    monkeypatch.setattr(check_smoother_bf16, "run",
                        lambda *a, **k: calls.append((a, k)) or out)
    check_smoother_bf16.main(["3", "--dtype", "bfloat16", "--device", "cpu"])
    assert calls == [((3, ["bfloat16"]), {"device": "cpu"})]
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["workload"] == "check-smoother-bf16"
