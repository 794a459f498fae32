"""The port's benchmark entry point (rbslam_tpu_torch/bench.py) and the
rebase-period sweep against bench.py and scripts/sweep_lowrank.py, on the
CPU.

bench.py's flags are read from its source; its rows are compared by
running both ``main`` functions with every engine call replaced by the
same stub (so no TPU or GPU number is involved), in a temporary working
directory: bench.py writes BENCH_EXTRA.json there. The metric strings must
equal bench.py's with ``,pallas-basis`` dropped, and the HBM fraction must
follow bench.py's formula with the H100's 3.35e12 B/s in place of v5e's
819e9. A quick run on the CPU (the kernels' plain versions) checks the
output's form.
"""

import ast
import json
import math
import os
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
from rbslam_tpu_torch import bench as tbench  # noqa: E402
from rbslam_tpu_torch.workloads import sweep_lowrank  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPARTURES = {"--pallas-basis", "--no-pallas-basis"}   # not taken
ADDED = {"--device", "--extra-out"}


def _jax_flags() -> dict:
    """bench.py's add_argument calls: flag -> its literal keywords."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {}
            for k in node.keywords:
                if isinstance(k.value, ast.Name):
                    kw[k.arg] = k.value.id
                elif k.arg in ("default", "choices", "action"):
                    kw[k.arg] = ast.literal_eval(k.value)
            flags[node.args[0].value] = kw
    return flags


def test_flags_match_bench():
    """Every flag of bench.py but the two departures, with its default,
    choices, type and action; the port adds only --device and
    --extra-out."""
    jax_flags = _jax_flags()
    assert DEPARTURES <= set(jax_flags)
    actions = {a.option_strings[0]: a for a in tbench._parser()._actions
               if a.option_strings and a.option_strings[0] != "-h"}
    missing = set(jax_flags) - DEPARTURES - set(actions)
    assert not missing, f"flags of bench.py the port lacks: {missing}"
    assert set(actions) - set(jax_flags) == ADDED
    for flag, kw in jax_flags.items():
        if flag in DEPARTURES:
            continue
        a = actions[flag]
        if "default" in kw:
            assert a.default == kw["default"], flag
        if "choices" in kw:
            assert list(a.choices) == kw["choices"], flag
        if "type" in kw:
            assert a.type.__name__ == kw["type"], flag
        if kw.get("action") == "store_true":
            assert a.const is True and a.default is False, flag


def _stub_rbpf(m_basis, n_particles, n_steps, *args, **kw):
    elapsed = 1e-6 * n_steps * (1 + m_basis % 7)   # differs by row
    return n_particles * n_steps / elapsed, elapsed, n_steps


def _stub_rbps_info(*args, **kw):
    return 3.0e4 + 0.25, 1.5, 192


def _stub_pf(n_particles, n_steps, *args, **kw):
    return n_particles * n_steps / 0.75, 0.75


@pytest.fixture
def stubbed(monkeypatch, tmp_path):
    """Both packages' engine calls replaced by the same stubs; bench.py's
    compilation cache made a no-op; a temporary working directory."""
    import rbslam_tpu.utils.cache as cache

    monkeypatch.setattr(cache, "enable_compilation_cache", lambda: None)
    for mod in (bench, tbench):
        monkeypatch.setattr(mod, "bench_rbpf", _stub_rbpf)
        monkeypatch.setattr(mod, "bench_rbps_info", _stub_rbps_info)
        monkeypatch.setattr(mod, "bench_pf", _stub_pf)
        monkeypatch.setattr(mod, "numpy_baseline_best",
                            lambda *a, **k: 2.5e-4)
    monkeypatch.chdir(tmp_path)
    return monkeypatch, tmp_path


def _run_both(stubbed, capsys, args):
    """(bench.py's JSON lines and extras, the port's stamp, JSON lines and
    extras) for the same arguments."""
    monkeypatch, tmp_path = stubbed
    monkeypatch.setattr(sys, "argv", ["bench.py", *args])
    bench.main()
    jax_lines = capsys.readouterr().out.strip().splitlines()
    with open(tmp_path / "BENCH_EXTRA.json") as f:
        jax_extra = json.load(f)
    out = tmp_path / "port_extra.json"
    assert tbench.main([*args, "--device", "cpu", "--extra-out",
                        str(out)]) == 0
    port_lines = capsys.readouterr().out.strip().splitlines()
    with open(out) as f:
        port_extra = json.load(f)
    return ([json.loads(s) for s in jax_lines], jax_extra, port_lines[0],
            [json.loads(s) for s in port_lines[1:]], port_extra)


HBM = re.compile(r",hbm=[0-9.]+")
ARGS = [[], ["--kf-kernel", "block_gather"], ["--ess", "0.5"],
        ["--cov-dtype", "float32"]]


@pytest.mark.parametrize("args", ARGS, ids=lambda a: " ".join(a) or "default")
def test_metric_names_match_bench(stubbed, capsys, args):
    """The rows of bench.py in its order, the headline last: each metric
    string is bench.py's without ",pallas-basis" (the HBM field compared
    in test_hbm_fraction_follows_bench), the values equal on the same
    stubbed engine times, and exactly the four keys."""
    jax_rows, _, card, port_rows, _ = _run_both(stubbed, capsys, args)
    assert card.startswith("card: cpu")
    assert len(port_rows) == len(jax_rows) == 6
    for j, p in zip(jax_rows, port_rows):
        assert set(p) == set(j) == {"metric", "value", "unit", "vs_baseline"}
        assert HBM.sub("", p["metric"]) == \
            HBM.sub("", j["metric"].replace(",pallas-basis", ""))
        assert ",pallas-basis" not in p["metric"]
        assert (p["value"], p["unit"], p["vs_baseline"]) == \
            (j["value"], j["unit"], j["vs_baseline"])
    assert "hbm=" in port_rows[-1]["metric"]


@pytest.mark.parametrize("args", ARGS, ids=lambda a: " ".join(a) or "default")
def test_hbm_fraction_follows_bench(stubbed, capsys, args):
    """bench.py's least bytes (2 N nl_pad^2 itemsize, nl padded to 128 on
    the kernel paths) over the step time, over 3.35e12 B/s: the port's
    fraction is bench.py's times 819e9 / 3.35e12 on the same step time,
    in the extras and in the headline string."""
    jax_rows, jax_extra, _, port_rows, port_extra = _run_both(
        stubbed, capsys, args)
    jax_frac = jax_extra["rbpf_hbm_roofline_fraction"]
    port_frac = port_extra["rbpf_hbm_roofline_fraction"]
    assert jax_frac > 100      # the stub's short steps: rounding is small
    # both rounded to 3 decimals
    assert port_frac == pytest.approx(jax_frac * 819e9 / 3.35e12, abs=1e-3)
    assert {k: v for k, v in port_extra.items()
            if k != "rbpf_hbm_roofline_fraction"} == \
        {k: v for k, v in jax_extra.items()
         if k != "rbpf_hbm_roofline_fraction"}
    got = float(HBM.search(port_rows[-1]["metric"]).group()[5:])
    assert got == pytest.approx(port_frac, abs=0.0051)


@pytest.mark.parametrize("n,m,kf_kernel,dtype,nl_pad,itemsize", [
    (16384, 125, "lowrank", "bfloat16", 128, 2),
    (4096, 509, "block_gather", "float32", 512, 4),
    (4096, 509, "xla", "float32", 512, 4),
    (128, 32, "lowrank", "bfloat16", 128, 2),
    (128, 32, "xla", "bfloat16", 35, 2),
])
def test_hbm_fraction_formula(n, m, kf_kernel, dtype, nl_pad, itemsize):
    step_s = 3.5e-3
    expect = 2 * n * nl_pad * nl_pad * itemsize / step_s / 3.35e12
    assert tbench.hbm_fraction(n, m, kf_kernel, dtype, step_s) == \
        pytest.approx(expect, rel=1e-12)


def test_numpy_grad_basis_equals_bench():
    from rbslam_tpu.basis import hypercube_basis

    b = hypercube_basis(40, np.array([2.0, 2.0, 1.0]))
    NN = np.asarray(b.NN, np.float64)
    L = np.asarray(b.L, np.float64)
    pos = np.random.default_rng(5).uniform(-1.5, 1.5, size=(17, 3))
    np.testing.assert_array_equal(tbench._numpy_grad_basis(pos, NN, L),
                                  bench._numpy_grad_basis(pos, NN, L))
    tb = tbench.hypercube_basis(40, np.array([2.0, 2.0, 1.0]))
    np.testing.assert_array_equal(tb.NN, b.NN)
    np.testing.assert_array_equal(tb.L, b.L)


def test_quick_run_on_cpu(capsys):
    """The card's stamp, the terrain PF row and the headline row last;
    each row has the four keys and finite positive values."""
    assert tbench.main(["--quick", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("card: cpu; torch ")
    rows = [json.loads(s) for s in lines[1:]]
    assert [r["metric"].split("[")[0] for r in rows] == [
        "terrain_pf_particle_steps_per_s",
        "rbpf_dense_mag_particle_steps_per_s"]
    assert rows[0]["metric"] == "terrain_pf_particle_steps_per_s[N_P=4096]"
    assert rows[1]["metric"].startswith(
        "rbpf_dense_mag_particle_steps_per_s[N_P=128,m=32+3,T=64,"
        "lowrank-kf-r8,bf16-cov,no-sym,hbm=")
    for r in rows:
        assert set(r) == {"metric", "value", "unit", "vs_baseline"}
        assert r["unit"] == "particle-steps/s"
        assert math.isfinite(r["value"]) and r["value"] > 0
    assert rows[0]["vs_baseline"] is None
    assert math.isfinite(rows[1]["vs_baseline"]) and rows[1]["vs_baseline"] > 0


@pytest.mark.parametrize("module", [tbench, sweep_lowrank])
def test_cuda_without_a_card_exits(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        module.main([])
    assert e.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("n_steps", [12, 192])
def test_problem_length_matches_bench(n_steps):
    problem, data = tbench._build_problem(13, 16, n_steps, device="cpu")
    ref = bench._build_problem(13, 16, n_steps)[0]
    assert int(problem.y.shape[0]) == int(ref.y.shape[0])
    assert data.pos.shape == (int(ref.y.shape[0]), 3)


def test_sweep_rows():
    """scripts/sweep_lowrank.py's configurations in its order, with its
    keys (at a small shape on the CPU)."""
    rows = sweep_lowrank.run(device="cpu", shape=(13, 16, 12))
    assert [r["config"] for r in rows] == [
        "xla", "block_gather", "lowrank-r4", "lowrank-r8", "lowrank-r16",
        "lowrank-r32", "lowrank-r64"]
    for r in rows:
        assert set(r) == {"config", "particle_steps_per_s", "step_ms",
                          "wall_s"}
        assert r["particle_steps_per_s"] > 0 and r["step_ms"] > 0


def test_terrain_problem_runs_on_cpu():
    """bench_pf's problem and filter at a tiny size, as bench_pf calls
    them: a finite ESS at every step and no kernel launched (the gridded
    terrain PF is plain PyTorch)."""
    from rbslam_tpu_torch.kernels import launch_counts, reset_launch_counts

    n, T = 256, 8
    problem = tbench.build_terrain_problem(n, T, device="cpu", n_grid=24,
                                           m_sim=64)
    reset_launch_counts()
    res = problem.run(tbench.terrain_config(n),
                      generator=torch.Generator().manual_seed(1))
    assert set(launch_counts().values()) == {0}
    assert res.ess.shape == (T,) and bool(torch.isfinite(res.ess).all())
    assert bool(torch.isfinite(res.traj_mean).all())
    err, err_end = tbench.terrain_position_error(problem, res)
    assert math.isfinite(err) and math.isfinite(err_end)
