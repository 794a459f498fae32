"""The basis kernels K1, K4, K6 and K7 at their main paths' shapes: the
form their planner picks, held bit for bit against a second launch and
against the direct form, and their device-only time beside their launch
interval and their bound; then K12 (the exact GP predictive) at the
exact localization cell's shape, beside its bound and its plain version.
With ``--parent``, the same kernels of another checkout of the port,
loaded in the same process, are timed in turns with this one, and their
outputs held against this one's bit for bit (K12 where the parent has
it).

    python -m rbslam_tpu_torch.workloads.basis_kernel_times \
        [--parent DIR] [--out FILE]

``DIR`` is the root of a checkout (for example a ``git archive`` of the
parent commit unpacked into a directory that ``.gitignore`` lists); its
``rbslam_tpu_torch`` package is imported under another name, so both
builds of the kernel library are loaded at once. Device-only time:
``profile_kernel_parts.device_ms`` (ten wrapper calls in one CUDA graph,
median of five replays). Launch interval: ``profile_kernel_parts.
time_stats`` (ten wrapper calls back to back between CUDA events, median
of five groups), which the host sets when a kernel is shorter than its
launch. The order of a case is parent, this tree, this tree, parent.
K12's inputs: K4's basis gradients at
65,536 positions over the cell's mapped area (m = 1000: 196,608 field rows
of width 1003) and the factor of a random symmetric positive definite
matrix for its posterior; its time does not depend on the values. Its
plain version is timed as the launch interval.
A last row times a one-element PyTorch op (``x.add_(0)`` on one float)
the same two ways: the launch floor that K6 at the radio shape is held
against. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import torch

from .. import kernels as this_kernels
from ..basis import hypercube_basis
from ..kernels.basis_eval import _basis_plan
from .profile_kernel_parts import bound_ms, device_ms, time_stats

BOUNDS3 = [[-20.0, -20.0, -2.4], [20.0, 20.0, 2.4]]
HALF = [9.0, 6.0, 2.4]

# (kernel, N, d, m, nl_pad, dtype): K1 on the lowrank path at the headline
# and reference shapes, K4 at the headline shape (xla and block_gather
# steps) and at the mag3d smoother's, K4 at d = 2, K6 at the radio path's
# shape, K7 at chip_smoke.py phase 9's (the smoothed trajectory) and at
# the headline shape
CASES = (
    ("jac3d_rows", 16384, 3, 125, 128, torch.bfloat16),
    ("jac3d_rows", 4096, 3, 509, 512, torch.float32),
    ("grad_basis", 16384, 3, 125, None, torch.float32),
    ("grad_basis", 100, 3, 512, None, torch.float32),
    ("grad_basis", 16384, 2, 128, None, torch.float32),
    ("phi_basis", 100, 2, 128, None, torch.float32),
    ("jac3d", 192, 3, 512, 640, torch.float32),
    ("jac3d", 16384, 3, 125, 128, torch.float32),
)
# K12 at the exact localization cell's shape: (N, m), the basis on the
# mapped area [-4, 4]^2 padded by 1.6, sigma2 the cell's theta[3]
PREDICTIVE = (65536, 1000)
LOC_BOUNDS = [[-5.6, -5.6, -1.6], [5.6, 5.6, 1.6]]
LOC_SIGMA2 = 4.0


def load_port(root, name: str):
    """The port in checkout ``root``, imported as package ``name`` (the
    port imports itself only relatively, and its kernel library builds
    into its own directory, so two checkouts load side by side)."""
    init = Path(root).resolve() / "rbslam_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(
        name, init, submodule_search_locations=[str(init.parent)])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def case_inputs(n, d, m, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    if d == 3:
        basis = hypercube_basis(m, BOUNDS3)
        x = (torch.rand((n, 3), generator=g, device=device) - 0.5) \
            * torch.tensor([36.0, 36.0, 4.0], device=device)
    else:
        basis = hypercube_basis(m, HALF[:d])
        x = (2 * torch.rand((n, d), generator=g, device=device) - 1) \
            * torch.tensor(HALF[:d], device=device)
    q = torch.randn((n, 4), generator=g, device=device)
    return basis, x, q / q.norm(dim=-1, keepdim=True)


def call(kernels, name, consts, x, q, nl_pad, dtype):
    if name == "jac3d_rows":
        return kernels.mag3d_jacobian_rows(consts, x, q, nl_pad, dtype)
    if name == "jac3d":
        return kernels.mag3d_jacobian(consts, x, q, nl_pad)
    return getattr(kernels, name)(consts, x)


def case_bound(name, n, d, m, nl_pad, dtype, consts):
    """bound_ms of one call: inputs read once (positions, quaternions for
    K1 and K7, the packed constants), the output written once; operations
    as chip_smoke.py counts them (a multiply, an add, a sin or a cos one
    each)."""
    item = torch.tensor([], dtype=dtype).element_size()
    const_bytes = consts.packed.numel() * 4
    if name in ("jac3d_rows", "jac3d"):
        nbytes = n * 3 * 4 + n * 4 * 4 + const_bytes + n * 3 * nl_pad * item
        flops = n * m * (3 * 2 + 3 * 2 + 3 * 4 + 3 * 5)
    elif name == "grad_basis":
        nbytes = n * d * 4 + const_bytes + n * d * m * 4
        flops = n * m * (d * 2 + d * 2 + d * (d + 1))
    else:
        nbytes = n * d * 4 + const_bytes + n * m * 4
        flops = n * m * d * 4
    return bound_ms(nbytes, flops, torch.float32)


def run(device, parent_root=None, seed=0):
    """One row per case: the planner's form (K1, K4, K7), whether two
    launches and the direct form on the same constants (forced by counts
    over the table's 256 offsets) give the same bits, device-only and
    launch-interval times of this tree (and of the parent, with equal
    outputs), and the bound."""
    trees = {"this": this_kernels}
    if parent_root is not None:
        load_port(parent_root, "_parent_rbslam_tpu_torch")
        trees["parent"] = importlib.import_module(
            "_parent_rbslam_tpu_torch.kernels")
    order = (("parent", "this", "this", "parent") if "parent" in trees
             else ("this", "this"))
    rows = []
    for i, (name, n, d, m, nl_pad, dtype) in enumerate(CASES):
        basis, x, q = case_inputs(n, d, m, device, seed + i)
        consts = {k: kern.pack_basis_constants(basis, device)
                  for k, kern in trees.items()}
        fns = {k: (lambda k=k, kern=kern: call(kern, name, consts[k], x, q,
                                               nl_pad, dtype))
               for k, kern in trees.items()}
        outs = {k: fn() for k, fn in fns.items()}
        torch.cuda.synchronize(device)
        equal = (None if "parent" not in trees
                 else torch.equal(outs["this"], outs["parent"]))
        again = torch.equal(fns["this"](), outs["this"])
        form = direct = None
        if name != "phi_basis":
            this = consts["this"]
            form = _basis_plan(name != "grad_basis", n, d, m, nl_pad or 0,
                               outs["this"].element_size(), this.counts)
            direct = torch.equal(
                call(this_kernels, name, this._replace(counts=(257,) * d),
                     x, q, nl_pad, dtype), outs["this"])
        dev = {k: [] for k in trees}
        launch = {k: [] for k in trees}
        for k in order:
            dev[k].append(device_ms(fns[k], device))
            launch[k].append(time_stats(fns[k], device))
        b, by = case_bound(name, n, d, m, nl_pad, dtype, consts["this"])
        rows.append({
            "kernel": name, "n": n, "d": d, "m": m, "nl_pad": nl_pad,
            "dtype": str(dtype).removeprefix("torch."),
            "shape": tuple(outs["this"].shape), "form": form,
            "bit_equal_to_parent": equal, "two_launches_equal": again,
            "equal_to_direct_form": direct,
            "device_ms": dev, "launch_interval_ms": launch,
            "bound_ms": b, "bound_by": by, "plain_ms": None,
        })
        del outs
    rows.append(predictive_row(device, trees, order, seed + len(CASES)))
    rows.append(launch_floor_row(device))
    return rows


def predictive_row(device, trees, order, seed) -> dict:
    """K12 at the exact localization cell's shape, as a row of :func:`run`:
    two launches bit-equal (and equal to the parent's, where the parent
    has K12), device-only time and launch interval, the bound (every
    row's n_lin^2 operations at the float32 peak, or its bytes: g, the
    table and the outputs once) and the plain version's launch interval
    (``plain_ms``)."""
    n, m = PREDICTIVE
    n_lin = m + 3
    this = trees["this"]
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.rand((n, 3), generator=g, device=device) - 0.5) \
        * torch.tensor([8.0, 8.0, 0.2], device=device)
    grad = this.grad_basis(
        this.pack_basis_constants(hypercube_basis(m, LOC_BOUNDS), device), x)
    host = torch.Generator().manual_seed(seed)
    A = torch.randn((n_lin, n_lin), generator=host, dtype=torch.float64)
    L = torch.linalg.cholesky(A @ A.T / n_lin
                              + torch.eye(n_lin, dtype=torch.float64))
    w = torch.randn(n_lin, generator=host, dtype=torch.float64).to(device)
    trees = {k: kern for k, kern in trees.items()
             if hasattr(kern, "gp_predictive")}
    consts = {k: kern.pack_predictive(L, w, LOC_SIGMA2)
              for k, kern in trees.items()}
    fns = {k: (lambda k=k, kern=kern: kern.gp_predictive(consts[k], grad))
           for k, kern in trees.items()}
    outs = {k: fn() for k, fn in fns.items()}
    torch.cuda.synchronize(device)

    def same(a, b):
        return all(torch.equal(u, v) for u, v in zip(a, b))

    dev = {k: [] for k in trees}
    launch = {k: [] for k in trees}
    for k in (k for k in order if k in trees):
        dev[k].append(device_ms(fns[k], device))
        launch[k].append(time_stats(fns[k], device))
    rows = 3 * n
    b, by = bound_ms(grad.numel() * 4 + consts["this"].table.numel() * 4
                     + 2 * rows * 4, rows * n_lin * n_lin, torch.float32)
    return {
        "kernel": "predictive", "n": n, "d": 3, "m": m, "nl_pad": None,
        "dtype": "float32", "shape": tuple(outs["this"][0].shape),
        "form": None,
        "bit_equal_to_parent": (same(outs["this"], outs["parent"])
                                if "parent" in outs else None),
        "two_launches_equal": same(fns["this"](), outs["this"]),
        "equal_to_direct_form": None,
        "device_ms": dev, "launch_interval_ms": launch,
        "bound_ms": b, "bound_by": by,
        "plain_ms": time_stats(
            lambda: this.gp_predictive_plain(consts["this"], grad), device),
    }


def launch_floor_row(device) -> dict:
    """The launch floor: ``x.add_(0)`` on a one-element float32 tensor,
    device-only and launch interval, twice each, as a row of :func:`run`
    (its bound: one float read and written)."""
    x = torch.zeros(1, device=device)

    def fn():
        return x.add_(0)

    b, by = bound_ms(8, 1, torch.float32)
    return {
        "kernel": "launch_floor", "n": 1, "d": None, "m": None,
        "nl_pad": None, "dtype": "float32", "shape": (1,), "form": None,
        "bit_equal_to_parent": None, "two_launches_equal": True,
        "equal_to_direct_form": None,
        "device_ms": {"this": [device_ms(fn, device),
                               device_ms(fn, device)]},
        "launch_interval_ms": {"this": [time_stats(fn, device),
                                        time_stats(fn, device)]},
        "bound_ms": b, "bound_by": by, "plain_ms": None,
    }


def floor_ratio(rows) -> float:
    """K6's device-only time at the radio shape (N=100, d=2, m=128) over
    the launch floor's: the lower of each one's medians."""
    k6 = next(r for r in rows if r["kernel"] == "phi_basis" and r["n"] == 100)
    floor = next(r for r in rows if r["kernel"] == "launch_floor")
    return (min(s[0] for s in k6["device_ms"]["this"])
            / min(s[0] for s in floor["device_ms"]["this"]))


def failed(rows) -> list:
    """The rows whose bits disagree with a second launch, the direct form
    or the parent."""
    return [r for r in rows if not r["two_launches_equal"]
            or r["equal_to_direct_form"] is False
            or r["bit_equal_to_parent"] is False]


def report(rows) -> list[str]:
    def fmt(stats):
        return " ".join(f"{s[0]:.4f} ({s[1]:.4f}-{s[2]:.4f})" for s in stats)

    lines = []
    for r in rows:
        form = ("" if r["form"] is None else
                f"table form, {r['form'][1]} particles a block; "
                if r["form"][0] else "direct form; ")
        lines.append(
            f"{r['kernel']} N={r['n']} d={r['d']} m={r['m']} "
            f"nl_pad={r['nl_pad']} {r['dtype']} -> {r['shape']}: {form}bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}); two launches equal "
            f"{r['two_launches_equal']}, equal to the direct form "
            f"{r['equal_to_direct_form']}, to the parent "
            f"{r['bit_equal_to_parent']}")
        for k in r["device_ms"]:
            lines.append(f"    {k:6s} device-only ms {fmt(r['device_ms'][k])};"
                         f" launch interval ms "
                         f"{fmt(r['launch_interval_ms'][k])}")
        if r["plain_ms"] is not None:
            lines.append(f"    plain  launch interval ms "
                         f"{fmt([r['plain_ms']])}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="root of another checkout of the port to compare")
    ap.add_argument("--out", default=None, help="also write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("basis_kernel_times needs a CUDA device")
    device = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip())
    rows = run(device, args.parent)
    print("\n".join(report(rows)))
    print(f"K6 at the radio shape over the launch floor, device-only: "
          f"{floor_ratio(rows):.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    bad = failed(rows)
    if bad:
        print(f"outputs differ: {[(r['kernel'], r['n'], r['m']) for r in bad]}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
