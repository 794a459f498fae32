"""Top-level CLI: `python -m rbslam_tpu_torch <workload> [args...]`.

Each workload runs on the card unless given ``--device cpu``.
"""

from __future__ import annotations

import importlib
import sys

_WORKLOADS = {
    "dense-radio": "rbslam_tpu_torch.workloads.dense_radio",
    "dense-mag": "rbslam_tpu_torch.workloads.dense_mag",
    "sparse-visual": "rbslam_tpu_torch.workloads.sparse_visual",
    "mag-localization": "rbslam_tpu_torch.workloads.mag_localization",
}


def main(argv=None):
    """Dispatch ``argv`` (default ``sys.argv[1:]``): the workload's name,
    then its own arguments. ``--help`` prints the usage and exits 0; no
    arguments print it and exit 2, as does an unknown name."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m rbslam_tpu_torch <workload> [args...]")
        print("workloads:", ", ".join(sorted(_WORKLOADS)))
        print("(pass --help after a workload name for its options)")
        raise SystemExit(0 if argv else 2)
    name = argv[0]
    if name not in _WORKLOADS:
        print(f"unknown workload {name!r}; options: {sorted(_WORKLOADS)}")
        raise SystemExit(2)
    importlib.import_module(_WORKLOADS[name]).main(argv[1:])


if __name__ == "__main__":
    main()
