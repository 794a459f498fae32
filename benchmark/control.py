"""The readings that a cell's correctness limits are set from: the
program's numbers (engines/<engine>.py::Cell.judge against the plain
reference) over many seeds, and its control's (``Cell.control``: the
program with TF32 matmuls on, or, for an engine that refuses TF32, the
reference run free with them on: the nearest precision below the
configuration's float32 with TF32 off), at the cell's own size; or the
readings of another ``--variant`` of ``Cell.control`` (a witness, a
planted fault) in the control's place. Each
seed builds the cell, makes the window's first call and judges it, as a
run judges its sampled call. The benchmark's own runs never run this.

    python3 benchmark/control.py --workload NAME --seeds 1 2 3 \
        --control-seeds 4 5 6 [--variant control] [--out FILE]

Prints one JSON line per seed, then the lower readings (the largest of
the program's) and the upper ones (the smallest of the control's).
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from benchmark import run  # noqa: E402


def reading(workload: str, seed: int, control: bool, device="cuda",
            overrides=None, variant: str = "control") -> dict:
    """The numbers of one judged call of the cell on ``seed``; with
    ``control`` the engine's control (or its ``variant``) takes the
    program's place (``Cell.control``). The reference judges with TF32
    off."""
    setup = run.prepare(workload, seed, device, overrides)
    noise = setup.noise("call", 0)
    if control:
        kept = setup.cell.control(noise, variant)
    else:
        out = setup.cell.call(noise)
        kept = setup.cell.retain(out)
        del out
    setup.sync()
    if setup.cuda:
        torch.cuda.empty_cache()
    return setup.cell.judge(kept, noise)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--variant", default="control")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    rows = []
    for control, seeds in ((False, args.seeds), (True, args.control_seeds)):
        for seed in seeds:
            nums = reading(args.workload, seed, control,
                           variant=args.variant)
            rows.append({"control": control and args.variant, "seed": seed,
                         **nums})
            print(json.dumps(rows[-1]), flush=True)
    names = [k for k in rows[0] if k not in ("control", "seed")]
    summary = {
        "lower": {k: max(r[k] for r in rows if not r["control"])
                  for k in names},
        "upper": {k: min(r[k] for r in rows if r["control"]) for k in names}
        if args.control_seeds else {},
    }
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(r) for r in rows + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
