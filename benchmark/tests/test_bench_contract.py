"""BENCHMARK.json against the benchmark's contract, the files it names
found by name, the result line's keys, and the imports of the harness and
of the plain reference."""

import json
import re
import subprocess
import sys

import pytest

from bench_small import CELL, ROOT, SMALL

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def test_top_level_keys_and_limits(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert bench["command"][1].startswith("benchmark/")
    assert 1 <= bench["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]]
    names += [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_follow_the_contract(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m["workloads"]) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists()
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_finds_its_files_by_name(bench):
    from benchmark import spec, traffic

    configs = {c["name"]: c for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        entry = spec.workload(bench, w["name"])
        assert entry["file"]["limits"]
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        assert configs[w["config"]]["file"] == \
            f"benchmark/configs/{w['config']}.json"
        assert set(configs[w["config"]]["reduced"]) == set(cfg["reduced"])
        assert traffic.load(w["traffic"])["n_particles"] > 0
        assert (ROOT / "benchmark" / "engines"
                / f"{cfg['engine']}.py").exists()
        assert (ROOT / "benchmark" / "reference"
                / f"{cfg['reference']}.py").exists()
        per_layer = spec.metrics_of(bench, "per_layer", w["name"])
        assert per_layer and all(hasattr(spec.reader(m["name"]), "read")
                                 for m in per_layer)


def test_result_line_has_the_contract_keys():
    from benchmark import run

    r = run.run(CELL, 2**31 + 11, 0.2, False, device="cpu", overrides=SMALL)
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(r)
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    assert set(r["metrics"]) == {"particle_steps_per_s", "peak_mem_gib",
                                 "setup_s"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(r["device"])


def test_a_run_without_a_card_prints_no_result(capsys, monkeypatch):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELL, "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def _top_level_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{str(ROOT)!r}); {code}; import json; print(json.dumps(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        check=True, capture_output=True, text=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    small = repr(SMALL)
    tops = _top_level_modules(
        "from benchmark import run, control, trace, roofline; "
        f"run.run({CELL!r}, 5, 0.1, False, device='cpu', overrides={small})")
    assert "rbslam_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "rbslam_tpu"}


def test_the_reference_loads_nothing_of_the_program():
    tops = _top_level_modules(
        "import benchmark.reference.rbpf_dense, benchmark.reference.basis, "
        "benchmark.problems.dense_mag")
    assert not tops & {"jax", "jaxlib", "flax", "rbslam_tpu",
                       "rbslam_tpu_torch"}


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "rbslam_tpu_torch_x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]
