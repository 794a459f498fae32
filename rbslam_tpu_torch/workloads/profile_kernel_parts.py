"""What holds the Kalman update kernels back: K2, K3 and K5 timed next to
their parts, the probes K8-K11 (port of scripts/profile_gather_cp.py,
profile_rebase_parts.py, profile_gather_kernel.py and profile_block_mxu.py
in one entry point).

On the dense-mag problem (C: the model's Jacobian at the initial state;
P = diag(k) in the storage dtype for the kernels that factor the innovation,
a random P for the others; random factor rows Wt), for three index patterns
(identity, sorted random, systematic ancestors of softmax(2 normal)
weights), each kernel is timed as the median of five groups of ``reps``
launches between CUDA events after one warm-up (the spread is printed; the
bare gather, the rebase's gather + write and ``torch.index_select`` in turns
on the same indices), next to its bound (its bytes, with a gathered matrix
counted once per distinct index, over 3.35 TB/s, or its operations over
the card's peak) and, for the bare gather, next to ``torch.index_select``.
The decomposition:

    K2 - K8                    what the factor term costs
    K3 against K9's variants   gather + write, dot + write, write only
    K5 against K10 + K11       the gather and the products apart

Run on the GPU:
    python -m rbslam_tpu_torch.workloads.profile_kernel_parts
(``--shape headline`` N=16384, m=125, bf16; ``--shape reference`` N=4096,
m=509, f32; default both). On the CPU (``--device cpu``) every function
runs once through its plain version and no time is reported.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from ..kernels import (
    gather_cp,
    kf_rebase,
    kf_update_block_gather,
    probe_block_products,
    probe_gather,
    probe_gather_cp,
    probe_rebase_parts,
)
from ..ops.resampling import systematic_resample
from .dense_mag import build_problem

SHAPES = {"headline": (16384, 125, "bfloat16"),
          "reference": (4096, 509, "float32")}
RW = 24                     # factor rows at a rebase: ny = 3 times r = 8
# NVIDIA H100 SXM data sheet: HBM3 bytes/s; dense FLOP/s outside the tensor
# cores (float32) and in them (bf16)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def bound_ms(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    """The least time the card could take, in milliseconds, and which term
    set it: the bytes over the memory rate ("bytes") or the operations
    over the peak rate of their type ("operations"), whichever is
    larger."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


GROUPS = 5                  # timed groups of ``reps`` launches per function


def time_alternately(fns: dict, device, reps: int = 10,
                     groups: int = GROUPS) -> dict:
    """Time several functions in turns on a CUDA device, so that a drift
    of the card's clocks meets all of them alike: after one warm-up call
    each, ``groups`` rounds in which every function in turn gets CUDA
    events around ``reps`` calls. Returns {name: (median, least, most)}
    milliseconds per call over the groups; the spread says how small a
    difference the medians can decide. On the CPU every function runs
    once and its entry is None: a CPU time is no device metric."""
    for fn in fns.values():
        fn()
    if device.type != "cuda":
        return dict.fromkeys(fns)
    torch.cuda.synchronize(device)
    times = {name: [] for name in fns}
    for _ in range(groups):
        for name, fn in fns.items():
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            times[name].append(start.elapsed_time(end) / reps)
    return {name: (sorted(ts)[len(ts) // 2], min(ts), max(ts))
            for name, ts in times.items()}


def time_stats(fn, device, reps: int = 10, groups: int = GROUPS):
    """(median, least, most) milliseconds per call of one function: see
    :func:`time_alternately`. None on the CPU."""
    return time_alternately({"fn": fn}, device, reps, groups)["fn"]


def device_ms(fn, device, reps: int = 10, groups: int = GROUPS):
    """(median, least, most) device-only milliseconds per call of one
    function: ``reps`` calls captured in one CUDA graph, the graph
    replayed ``groups`` times between CUDA events after one warm-up
    replay. The replays launch no Python, so this is the kernels' own
    time (and the gaps between them inside the graph), where
    :func:`time_stats` gives the launch interval, which the host sets
    for a kernel shorter than its launch. The kernel wrappers launch on
    the current stream, which is the capture stream; their outputs come
    from the graph's memory pool. None on the CPU (after one call)."""
    fn()
    if device.type != "cuda":
        return None
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()                            # warm-up off the default stream
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn() for _ in range(reps)]
    graph.replay()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(groups):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(end) / reps)
    del outs, graph
    return sorted(times)[len(times) // 2], min(times), max(times)


def time_ms(fn, device, reps: int = 10, groups: int = GROUPS):
    """Median milliseconds per call on a CUDA device over ``groups`` groups
    of ``reps`` calls after one warm-up call (1 + groups * reps calls in
    all). On the CPU the function runs once and None is returned."""
    stats = time_stats(fn, device, reps, groups)
    return None if stats is None else stats[0]


def index_patterns(n: int, generator: torch.Generator, device) -> dict:
    """The three int32 index vectors [n]: identity; sorted uniform random
    (scripts/profile_gather_kernel.py:84); systematic ancestors of
    softmax(2 normal) weights (scripts/profile_rebase_parts.py:17-19)."""
    ident = torch.arange(n, dtype=torch.int32, device=device)
    rand = torch.sort(torch.randint(0, n, (n,), generator=generator,
                                    device=device)).values.to(torch.int32)
    w = torch.softmax(2.0 * torch.randn(n, generator=generator,
                                        device=device), dim=0)
    anc = systematic_resample(torch.tensor(0.5, device=device), w, n)
    return {"identity": ident, "sorted_random": rand,
            "systematic": anc.to(torch.int32)}


def run(device="cuda", shape="headline", *, generator=None, reps: int = 10,
        seed: int = 1) -> dict:
    """Time the probes and K2, K3, K5 at one shape on ``device``.

    ``shape`` names an entry of ``SHAPES`` or is (n_particles, m_basis,
    cov_dtype); the map width is nl = 3 + m_basis padded to a multiple of
    128. ``generator`` (on ``device``) draws the random inputs; by default
    it is seeded with ``seed``, as the dataset is. Returns a dictionary
    with one row per (kernel, index pattern) and the decomposition.
    """
    device = torch.device(device)
    n, m, cov_dtype = SHAPES[shape] if isinstance(shape, str) else shape
    dtype = _DTYPES[cov_dtype]
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(seed)
    problem, _ = build_problem(m, 64, seed=seed, m_sim=64, device=device)
    n_lin = problem.model.n_lin
    nl = -(-n_lin // 128) * 128
    pad = nl - n_lin
    f32 = torch.float32

    xn0 = problem.x0_nonlin.expand(n, -1).contiguous()
    C = torch.nn.functional.pad(problem.model.meas_jacobian_batch(xn0),
                                (0, pad)).contiguous()       # [n, 3, nl] f32
    C_st = C.to(dtype)
    P_diag = torch.nn.functional.pad(problem.P0_lin, (0, pad, 0, pad)) \
        .to(dtype).expand(n, nl, nl).contiguous()
    P_rand = torch.randn((n, nl, nl), generator=generator, device=device,
                         dtype=f32).to(dtype)
    Wt = (0.1 * torch.randn((n, RW, nl), generator=generator, device=device,
                            dtype=f32)).to(dtype)
    xl = torch.zeros((n, nl), device=device)
    y = problem.y[0]
    patterns = index_patterns(n, generator, device)

    item = P_rand.element_size()
    mat = nl * nl * item                   # one particle's covariance
    ny = C.shape[1]
    small = {"C": C.numel() * 4, "C_st": C_st.numel() * item,
             "Wt": Wt.numel() * item, "CP": n * ny * nl * 4, "idx": n * 4}
    rows = []

    def add(name, pattern, stats, nbytes, flops, unique=None):
        ms, lo, hi = stats if stats is not None else (None, None, None)
        b, bound_by = bound_ms(nbytes, flops, dtype)
        rows.append({
            "kernel": name, "pattern": pattern, "ms": ms, "ms_min": lo,
            "ms_max": hi, "bound_ms": b, "bound_by": bound_by,
            "bytes": nbytes, "unique_indices": unique,
            "tb_per_s": None if ms is None else nbytes / (ms * 1e-3) / 1e12,
        })
        return ms

    def timed(fn):
        return time_stats(fn, device, reps)

    t = {}
    for pattern, idx in patterns.items():
        u = int(torch.unique(idx).numel())
        read, write = u * mat, n * mat
        idx64 = idx.long()
        # the three copies in turns on the same indices
        copies = time_alternately({
            "probe_gather": lambda: probe_gather(idx, P_rand),
            "gather_write": lambda: probe_rebase_parts(idx, Wt, P_rand, True,
                                                       False),
            "index_select": lambda: torch.index_select(P_rand, 0, idx64),
        }, device, reps)
        t[pattern] = {
            "probe_gather": add(
                "probe_gather (K10)", pattern, copies["probe_gather"],
                small["idx"] + read + write, 0, u),
            "index_select": add(
                "torch.index_select", pattern, copies["index_select"],
                small["idx"] + read + write, 0, u),
            "probe_gather_cp": add(
                "probe_gather_cp (K8)", pattern,
                timed(lambda: probe_gather_cp(idx, C, P_diag)),
                small["idx"] + small["C"] + read + small["CP"],
                2 * n * ny * nl * nl, u),
            "gather_cp": add(
                "gather_cp (K2)", pattern,
                timed(lambda: gather_cp(idx, C_st, Wt, P_diag)),
                small["idx"] + small["C_st"] + small["Wt"] + read
                + small["CP"], 2 * n * ny * nl * (nl + 2 * RW), u),
            "gather_write": add(
                "probe_rebase_parts gather+write (K9)", pattern,
                copies["gather_write"],
                small["idx"] + read + write, 0, u),
            "gather_dot_write": add(
                "probe_rebase_parts gather+dot+write (K9)", pattern,
                timed(lambda: probe_rebase_parts(idx, Wt, P_rand, True,
                                                 True)),
                small["idx"] + small["Wt"] + read + write,
                2 * n * RW * nl * nl, u),
            "rebase": add(
                "kf_rebase (K3)", pattern,
                timed(lambda: kf_rebase(idx, Wt, P_rand)),
                small["idx"] + small["Wt"] + read + write,
                2 * n * RW * nl * nl, u),
            "block_gather": add(
                "kf_update_block_gather (K5)", pattern,
                timed(lambda: kf_update_block_gather(idx, C, xl, P_diag, y,
                                                     problem.R, 1e-3)),
                small["idx"] + small["C"] + 2 * xl.numel() * 4 + read + write,
                4 * n * ny * nl * nl, u),
        }
    ident = patterns["identity"]
    no_gather = {
        "dot_write": add(
            "probe_rebase_parts dot+write (K9)", None,
            timed(lambda: probe_rebase_parts(ident, Wt, P_rand, False, True)),
            small["Wt"] + n * mat, 2 * n * RW * nl * nl),
        "write_only": add(
            "probe_rebase_parts write only (K9)", None,
            timed(lambda: probe_rebase_parts(ident, Wt, P_rand, False, False)),
            n * mat, 0),
        "block_products": add(
            "probe_block_products (K11)", None,
            timed(lambda: probe_block_products(C, P_rand)),
            small["C"] + 2 * n * mat, 4 * n * ny * nl * nl),
    }

    def diff(a, b):
        return None if a is None else a - b

    def total(a, b):
        return None if a is None else a + b

    decomposition = {
        pattern: {
            "K2_minus_K8_ms": diff(tp["gather_cp"], tp["probe_gather_cp"]),
            "K3_ms": tp["rebase"],
            "K3_minus_gather_write_ms": diff(tp["rebase"],
                                              tp["gather_write"]),
            "K3_minus_dot_write_ms": diff(tp["rebase"],
                                           no_gather["dot_write"]),
            "K3_minus_write_only_ms": diff(tp["rebase"],
                                            no_gather["write_only"]),
            "K5_ms": tp["block_gather"],
            "K10_plus_K11_ms": total(tp["probe_gather"],
                                     no_gather["block_products"]),
            "K10_over_index_select": (
                None if tp["probe_gather"] is None
                else tp["probe_gather"] / tp["index_select"]),
            "K9_gather_write_over_index_select": (
                None if tp["gather_write"] is None
                else tp["gather_write"] / tp["index_select"]),
            "K3_over_gather_write": (
                None if tp["rebase"] is None
                else tp["rebase"] / tp["gather_write"]),
        }
        for pattern, tp in t.items()
    }
    return {
        "workload": "profile-kernel-parts",
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "n_particles": n, "m_basis": m, "nl": nl, "rw": RW,
        "cov_dtype": cov_dtype, "reps": reps, "groups": GROUPS,
        "rows": rows, "decomposition": decomposition,
    }


def print_table(out: dict) -> None:
    print(f"N={out['n_particles']} nl={out['nl']} rw={out['rw']} "
          f"{out['cov_dtype']} on {out['device']}, median (least-most) of "
          f"{out['groups']} groups of {out['reps']} launches")
    print(f"{'kernel':44s} {'indices':14s} {'distinct':>8s} {'ms':>9s} "
          f"{'spread':>15s} {'bound ms':>9s} {'TB/s':>7s}")
    for r in out["rows"]:
        ms = "-" if r["ms"] is None else f"{r['ms']:.4f}"
        spread = "-" if r["ms"] is None \
            else f"{r['ms_min']:.4f}-{r['ms_max']:.4f}"
        tb = "-" if r["tb_per_s"] is None else f"{r['tb_per_s']:.3f}"
        u = "-" if r["unique_indices"] is None else str(r["unique_indices"])
        print(f"{r['kernel']:44s} {r['pattern'] or '-':14s} {u:>8s} "
              f"{ms:>9s} {spread:>15s} {r['bound_ms']:9.4f} {tb:>7s}")
    for pattern, d in out["decomposition"].items():
        print(f"  {pattern}: " + ", ".join(
            f"{k}={'-' if v is None else format(v, '.4f')}"
            for k, v in d.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shape", default="both",
                    choices=["both", *SHAPES])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True).stdout.strip())
    for name in SHAPES if args.shape == "both" else (args.shape,):
        out = run(device, name, reps=args.reps, seed=args.seed)
        print_table(out)
        print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
