"""Hold the port's reproduction runs against the JAX package's recorded runs
of the same experiments, and print a verdict for each comparison.

- Dense-mag boxplots (``dense_mag_boxplot.json``, ``..._lowrank.json``):
  for each disturbance o and method (EKF, PF, PS), a two-sided Mann-Whitney
  U test of the port's per-run RMSEs (``raw``) against the JAX file's. Both
  sides draw an independent dataset per seed, so the test holds although
  the two simulators draw otherwise. The paper's findings must also hold
  in each port file: PF and PS medians at most 0.3 m at every o, and at
  o = 10 the EKF median above 0.4 m and above the PF and PS medians.
- Dense radio (``dense_radio_{line,square}_mc100.json``, the port's runs on
  the JAX package's field): each column of ``rmse_filter_all`` (max-weight,
  weighted mean) by Mann-Whitney U, in the same family; and the JAX final
  smoother RMSE (``rmse_smoother_final``; for line_3D also the median of
  ``line_figures_summary.json``) inside the port's 99 % bootstrap interval
  of the same statistic over its runs (10,000 resamples, numpy seed 0),
  widened by sqrt(2) about its centre, since the JAX value carries the
  same sampling noise.

The Mann-Whitney p-values are corrected together by Holm at a family alpha
of 0.01. A port run with a NaN fails its comparison. Runs on the port's own
radio field (``..._own_field.json``) and runs with every product's operands
rounded to bfloat16 (``..._bf16_matmul.json``, ``--bf16-matmul-inputs``)
are held to the same JAX files and reported beside them, outside the
family.

    python -m rbslam_tpu_torch.reproduce.compare [--port results/h100]
        [--reference results] [--out results/h100/compare.json]

exits 0 when every verdict passes, else 1.
"""

from __future__ import annotations

import argparse
import math
import os
import sys

import numpy as np
from scipy.stats import mannwhitneyu

from .common import emit, load

ALPHA = 0.01
METHODS = ("ekf", "pf", "ps")
BOXPLOTS = ("dense_mag_boxplot", "dense_mag_boxplot_lowrank")
RADIO = ("dense_radio_line_mc100", "dense_radio_square_mc100")
FILTER_COLUMNS = ("max", "mean")
# runs reported beside the family: the port's own radio field, and the
# port with every product's operands rounded to bfloat16
ASIDE = ("_own_field", "_bf16_matmul")


def _finite(x) -> tuple[np.ndarray, int]:
    x = np.asarray(x, dtype=np.float64)
    ok = np.isfinite(x)
    return x[ok], int((~ok).sum())


def mann_whitney(name: str, port, ref) -> dict:
    """A two-sided Mann-Whitney U test of ``port`` against ``ref``; NaN
    runs of the port are dropped from the test and counted."""
    a, nan = _finite(port)
    b, _ = _finite(ref)
    p = float(mannwhitneyu(a, b, alternative="two-sided").pvalue) \
        if len(a) and len(b) else float("nan")
    return {"name": name, "p": p, "nan_runs": nan, "n": [len(a), len(b)],
            "median": [float(np.median(a)) if len(a) else float("nan"),
                       float(np.median(b))]}


def holm(pvalues) -> list[float]:
    """Holm's step-down adjusted p-values, in the order given."""
    m = len(pvalues)
    order = sorted(range(m), key=lambda i: pvalues[i])
    adjusted, running = [0.0] * m, 0.0
    for k, i in enumerate(order):
        running = max(running, min(1.0, (m - k) * pvalues[i]))
        adjusted[i] = running
    return adjusted


def bootstrap_interval(x, stat=np.mean, level: float = 0.99,
                       n_resamples: int = 10_000, seed: int = 0,
                       widen: float = math.sqrt(2)) -> list[float]:
    """The percentile bootstrap interval of ``stat`` over ``x`` at
    ``level``, its half-width multiplied by ``widen`` about its centre."""
    x = np.asarray(x, dtype=np.float64)
    rng = np.random.default_rng(seed)
    draws = stat(x[rng.integers(0, len(x), (n_resamples, len(x)))], axis=1)
    lo, hi = np.quantile(draws, [(1 - level) / 2, (1 + level) / 2])
    mid, half = (lo + hi) / 2, (hi - lo) / 2 * widen
    return [float(mid - half), float(mid + half)]


def interval_check(name: str, port_runs, ref_value: float,
                   stat=np.mean) -> dict:
    runs, nan = _finite(port_runs)
    lo, hi = bootstrap_interval(runs, stat)
    return {"name": name, "ref": float(ref_value), "interval": [lo, hi],
            "port": float(stat(runs)), "nan_runs": nan,
            "ok": nan == 0 and lo <= ref_value <= hi}


def boxplot_tests(tag: str, port: dict, ref: dict) -> list[dict]:
    return [mann_whitney(f"{tag} o={o} {m}", port["raw"][o][m],
                         ref["raw"][o][m])
            for o in ref["raw"] if o in port["raw"] for m in METHODS]


def paper_findings(tag: str, d: dict) -> list[dict]:
    """PF and PS medians at most 0.3 m at every o; at o = 10, the EKF
    median above 0.4 m and above the PF and PS medians."""
    med = {o: {m: float(np.median(_finite(r[m])[0])) for m in METHODS}
           for o, r in d["raw"].items()}
    checks = [{"name": f"{tag} o={o} {m} median <= 0.3 m",
               "value": v[m], "ok": v[m] <= 0.3}
              for o, v in med.items() for m in ("pf", "ps")]
    if "10.0" in med:
        v = med["10.0"]
        checks.append({
            "name": f"{tag} o=10.0 ekf median > 0.4 m and > pf, ps medians",
            "value": [v["ekf"], v["pf"], v["ps"]],
            "ok": v["ekf"] > 0.4 and v["ekf"] > v["pf"]
            and v["ekf"] > v["ps"]})
    return checks


def radio_tests(tag: str, port: dict, ref: dict) -> list[dict]:
    p, r = np.asarray(port["rmse_filter_all"]), np.asarray(
        ref["rmse_filter_all"])
    return [mann_whitney(f"{tag} filter {c}", p[:, j], r[:, j])
            for j, c in enumerate(FILTER_COLUMNS)]


def radio_intervals(tag: str, port: dict, ref: dict,
                    ref_median=None) -> list[dict]:
    runs = port["rmse_smoother_final_all"]
    checks = [interval_check(f"{tag} smoother final mean", runs,
                             ref["rmse_smoother_final"])]
    if ref_median is not None:
        checks.append(interval_check(f"{tag} smoother final median", runs,
                                     ref_median, np.median))
    return checks


def verdicts(port: dict, ref: dict, alpha: float = ALPHA) -> dict:
    """``port`` and ``ref`` map file stems (``dense_mag_boxplot``, ...,
    ``line_figures_summary`` in ``ref``) to results; a stem missing from
    ``port`` is skipped. Returns the family's tests with their Holm
    p-values, the checks, what is reported outside the family, and
    ``ok``."""
    tests, checks, reported = [], [], []
    for stem in BOXPLOTS:
        if stem in port:
            tests += boxplot_tests(stem, port[stem], ref[stem])
            checks += paper_findings(stem, port[stem])
        for aside in (stem + a for a in ASIDE if stem + a in port):
            reported += boxplot_tests(aside, port[aside], ref[stem])
            reported += paper_findings(aside, port[aside])
    median = ref.get("line_figures_summary", {}).get("rmse_smoother_median")
    for stem in RADIO:
        ref_median = median if "line" in stem else None
        if stem in port:
            tests += radio_tests(stem, port[stem], ref[stem])
            checks += radio_intervals(stem, port[stem], ref[stem],
                                      ref_median)
        for aside in (stem + a for a in ASIDE if stem + a in port):
            reported += radio_tests(aside, port[aside], ref[stem])
            reported += radio_intervals(aside, port[aside], ref[stem],
                                        ref_median)
    for t, p in zip(tests, holm([t["p"] for t in tests])):
        t["p_holm"] = p
        t["ok"] = t["nan_runs"] == 0 and p > alpha
    return {"alpha": alpha, "family": len(tests), "mann_whitney": tests,
            "checks": checks, "reported": reported,
            "ok": all(t["ok"] for t in tests + checks)}


def _line(v: dict, status=None) -> str:
    if status is None:
        status = "PASS" if v["ok"] else "FAIL"
    if "p" in v:
        s = (f"{v['name']}: Mann-Whitney U p={v['p']:.4g}"
             + (f" (Holm {v['p_holm']:.4g})" if "p_holm" in v else "")
             + f", medians port {v['median'][0]:.4g} / JAX "
             f"{v['median'][1]:.4g}, n {v['n'][0]}/{v['n'][1]}")
    elif "interval" in v:
        s = (f"{v['name']}: JAX {v['ref']:.6g} in the port's widened 99 % "
             f"interval [{v['interval'][0]:.6g}, {v['interval'][1]:.6g}] "
             f"(port {v['port']:.6g})")
    else:
        s = f"{v['name']}: {v['value']}"
    if v.get("nan_runs"):
        s += f", {v['nan_runs']} NaN runs"
    return f"{status} {s}"


def print_verdicts(out: dict, prefix: str = "",
                   status: str | None = None) -> None:
    """One line a verdict; ``status`` (such as "REPORTED") in place of
    PASS / FAIL where the samples are too small to judge."""
    for v in out["mann_whitney"] + out["checks"]:
        print(prefix + _line(v, status), flush=True)
    for v in out["reported"]:
        print(prefix + _line(v, "REPORTED"), flush=True)


def load_dir(path: str, stems) -> dict:
    return {s: load(os.path.join(path, s + ".json")) for s in stems
            if os.path.exists(os.path.join(path, s + ".json"))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--port", default="results/h100",
                    help="directory of the port's results")
    ap.add_argument("--reference", default="results",
                    help="directory of the JAX package's results")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    stems = BOXPLOTS + RADIO
    port = load_dir(args.port, stems + tuple(s + a for s in stems
                                             for a in ASIDE))
    ref = load_dir(args.reference, stems + ("line_figures_summary",))
    out = verdicts(port, ref)
    print_verdicts(out)
    emit(out, args.out)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
