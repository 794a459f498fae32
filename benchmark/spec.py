"""What BENCHMARK.json names, found by name: a cell's entry and its file
(``workloads/<cell>.json``: the limits of its correctness check), its
configuration (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``, read by traffic.py), and the per-layer
metrics' readers (``metrics/<metric>.py``, each with ``read(ctx)``)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return _json(ROOT / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    """The cell's entry of BENCHMARK.json, with its file under ``file``."""
    for w in bench["workloads"]:
        if w["name"] == name:
            return {**w, "file": _json(HERE / "workloads" / f"{name}.json")}
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return _json(HERE / "configs" / f"{name}.json")


def metrics_of(bench: dict, group: str, cell: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that cell reports."""
    return [m for m in bench[group]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str):
    """The module ``metrics/<name>.py`` (names may hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '__')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
