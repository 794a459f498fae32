"""The benchmark of rbslam_tpu_torch, the PyTorch and CUDA port, on NVIDIA
GPUs. One run is one process: it builds a cell of BENCHMARK.json from the
seed, warms its shapes with one engine call, then measures a closed loop of
one caller (engine calls back to back, each over one whole trajectory with
fresh draws, each ending in a device synchronize) for ``--seconds``, judges
one call of the window drawn from the seed against the plain reference, and
prints one JSON line.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

``--trace 0`` reports the cell's end-to-end metrics; ``--trace 1`` its
per-layer metrics, read after the window from one call under the
host-device sync counter and one under ``torch.profiler``. The run fails
(exit 2, no result) without enough CUDA devices, and (exit 3, no result)
if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import spec, traffic as traffic_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rbslam_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for k, v in extra.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(
            out.get(k), dict) else v
    return out


def prepare(workload: str, seed: int, device="cuda", overrides=None):
    """The cell ``workload`` of BENCHMARK.json built on ``device`` from the
    seed, with its files and the helpers a run needs (``sync()``,
    ``noise(stream, k)``: the draws of one call)."""
    overrides = overrides or {}
    bench = spec.benchmark()
    entry = spec.workload(bench, workload)
    traffic = _merge(traffic_mod.load(entry["traffic"]),
                     overrides.get("traffic", {}))
    # a mix may set the configuration's engine or data settings it varies
    config = _merge(_merge(spec.config(entry["config"]),
                           traffic.get("config", {})),
                    overrides.get("config", {}))
    device = torch.device(device)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(config["matmul_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["matmul_tf32"])
    engine = importlib.import_module(f"benchmark.engines.{config['engine']}")
    cell = engine.Cell(config, traffic, seed, device)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def noise(stream, k):
        return traffic_mod.draws(cell.noise_shapes, seed, stream, k, device)

    return SimpleNamespace(bench=bench, entry=entry, config=config,
                           traffic=traffic, cell=cell, device=device,
                           cuda=cuda, sync=sync, noise=noise)


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", overrides=None, t_start: float = T_START) -> dict:
    """One run of the cell ``workload``; returns the result line's object.
    ``overrides`` (``{"config": {...}, "traffic": {...}}``, merged into the
    files) and a CPU ``device`` serve the tests, which run the whole harness
    at a small size on the kernels' plain versions."""
    t_run = time.perf_counter()
    setup = prepare(workload, seed, device, overrides)
    t_built = time.perf_counter()
    bench, entry, cell, cuda = setup.bench, setup.entry, setup.cell, setup.cuda
    device = setup.device
    sync, noise = setup.sync, setup.noise

    out = cell.warm()                        # every shape of a call
    sync()
    del out
    setup_s = time.perf_counter() - t_start
    parts = {"imports": t_run - t_start, "data_and_model": t_built - t_run,
             "warm_call": t_start + setup_s - t_built}

    # --- the measured window: one caller, calls back to back -----------
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    pick = random.Random(traffic_mod.stream_seed(seed, "sample", 1))
    attempted = failed = completed = 0
    walls, kept, errors = [], None, []
    t0 = time.perf_counter()
    while True:
        k = attempted
        attempted += 1
        tc = time.perf_counter()
        try:
            out = cell.call(noise("call", k))
            sync()
            ok = cell.finite(out)
        except Exception as exc:   # a failed call is counted, not fatal
            out, ok = None, False
            errors.append(f"call {k}: {type(exc).__name__}: {exc}")
        walls.append(time.perf_counter() - tc)
        if ok:
            completed += 1
            # reservoir sample of one completed call, drawn from the seed
            if pick.random() * completed < 1.0:
                kept = None                  # free the old copy first
                kept = (k, cell.retain(out))
        else:
            failed += 1
        del out
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": attempted, "failed": failed}
    if not trace:
        names = spec.metrics_of(bench, "end_to_end", workload)
        values = {"peak_mem_gib": peak / 2**30, "setup_s": setup_s}
        # particle_steps_per_s, or the host-bound cells' particle_steps_per_s.host
        rate = completed * cell.work_per_call / window_s
        values.update((m["name"], rate) for m in names
                      if m["name"].split(".")[0] == "particle_steps_per_s")
    else:
        from benchmark import trace as trace_mod

        marks = [time.perf_counter()]
        syncs = trace_mod.count_syncs(lambda: cell.call(noise("warm", 1)))
        sync()
        marks.append(time.perf_counter())
        traced = trace_mod.traced_call(lambda: cell.call(noise("warm", 2)))
        marks.append(time.perf_counter())
        traced = traced._replace(out=SimpleNamespace(
            ancestors=traced.out.ancestors.clone()))
        ctx = SimpleNamespace(cell=cell, trace=traced, syncs=syncs,
                              steps=cell.steps_per_call,
                              untraced_wall_s=statistics.median(walls))
        names = spec.metrics_of(bench, "per_layer", workload)
        values = {m["name"]: spec.reader(m["name"]).read(ctx) for m in names}
        dev["busy_s"] = trace_mod.busy_us(traced) * 1e-6
        dev["window_s"] = traced.wall_s
        result["breakdown"] = trace_mod.breakdown(traced)
        marks.append(time.perf_counter())
        parts.update(trace_syncs=marks[1] - marks[0],
                     trace_call=marks[2] - marks[1],
                     trace_reduce=marks[3] - marks[2])
        del traced, ctx
    result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                     "unit": m["unit"]}
                         for m in names if values.get(m["name"]) is not None}
    result["device"] = dev

    # --- correctness: the kept call against the plain reference ----------
    limits = entry["file"]["limits"]
    numbers = {}
    if kept is not None:
        if cuda:
            torch.cuda.empty_cache()
        k, retained = kept
        t_judge = time.perf_counter()
        try:
            numbers = cell.judge(retained, noise("call", k))
        except Exception as exc:  # noqa: BLE001 - reported, judged wrong
            errors.append(f"reference: {type(exc).__name__}: {exc}")
        parts["judge"] = time.perf_counter() - t_judge
    checks = {name: {"value": numbers.get(name), "limit": limit}
              for name, limit in limits.items()}
    result["correct"] = bool(
        failed == 0 and kept is not None and all(
            c["value"] is not None and math.isfinite(c["value"])
            and c["value"] <= c["limit"] for c in checks.values()))
    result["errors"] = errors[:5]
    result["call_walls_s"] = walls
    result["parts_s"] = parts
    result["checks"] = checks              # the compared numbers come last
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.benchmark()
    chips = spec.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {found}: JAX or the JAX package",
              file=sys.stderr)
        return 3
    for err in result["errors"]:
        print(f"benchmark: {err}", file=sys.stderr)
    print("benchmark: set-up and after-window parts (s) " + " ".join(
        f"{k} {v:.3f}" for k, v in result.pop("parts_s").items()),
        file=sys.stderr)
    print("benchmark: call walls (s) "
          + " ".join(f"{w:.4f}" for w in result.pop("call_walls_s")),
          file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
