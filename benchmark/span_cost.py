"""What the program's span recorder costs. ``--off`` times the off path of
``phase_annotation`` (entry plus exit, recording and the profiler off) on
the host; ``--workload`` times untraced engine calls of a cell with
recording off and on, in turns (off-on, then on-off), after one warm
call, each ending in a device synchronize. The benchmark's runs never run
this.

    python3 benchmark/span_cost.py --off
    python3 benchmark/span_cost.py --workload NAME --seed N --pairs 6

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402


def off_path_ns(number: int = 100000, repeat: int = 7) -> float:
    """Best of ``repeat`` runs: ns for one ``with phase_annotation("step",
    t=1): pass`` with recording and the profiler off."""
    from rbslam_tpu_torch.utils import phase_annotation

    def once():
        with phase_annotation("step", t=1):
            pass
    return min(timeit.repeat(once, number=number, repeat=repeat)) \
        / number * 1e9


def pairs(workload: str, seed: int, n_pairs: int, device="cuda") -> dict:
    """Walls (s) of untraced calls with recording off and on, in turns."""
    from rbslam_tpu_torch.utils import recording

    setup = run.prepare(workload, seed, device)
    setup.cell.warm()
    setup.sync()
    walls = {"off": [], "on": []}
    k = 0
    for i in range(n_pairs):
        for mode in (("off", "on") if i % 2 == 0 else ("on", "off")):
            noise = setup.noise("call", k)
            k += 1
            t0 = time.perf_counter()
            if mode == "on":
                with recording() as rec:
                    out = setup.cell.call(noise)
                    setup.sync()
            else:
                out = setup.cell.call(noise)
                setup.sync()
            walls[mode].append(time.perf_counter() - t0)
            del out
    on, off = (statistics.median(walls[m]) for m in ("on", "off"))
    return {"workload": workload, "seed": seed, "walls_s": walls,
            "median_on_over_off": on / off, "spans_a_call": len(rec.spans),
            "device": torch.cuda.get_device_name() if setup.cuda else "cpu"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--off", action="store_true")
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--pairs", type=int, default=6)
    args = ap.parse_args(argv)
    if args.off:
        print(json.dumps({"off_path_ns": off_path_ns()}))
    if args.workload:
        torch.set_num_threads(1)
        print(json.dumps(pairs(args.workload, args.seed, args.pairs)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
