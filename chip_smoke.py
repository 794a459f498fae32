"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU (Hopper, sm_90a):
checks only. Nothing here is timed: the benchmark (benchmark/run.py, the
cells of BENCHMARK.json) measures the port, and
workloads/profile_kernel_parts.py and workloads/basis_kernel_times.py time
its kernels alone.

Run from the repository root:  python3 chip_smoke.py

Phases (each prints its own lines; any failure raises, exit code != 0;
each makes every one of its runs once):
 1. require CUDA; print the card's name and power limit; turn TF32 off;
 2. build the CUDA kernels from rbslam_tpu_torch/csrc (one nvcc per
    source, started together, at first use);
 3. compare each kernel with its plain PyTorch version at the main
    paths' shapes; K6 launched twice for equal bits; K1 also between
    guard bands (canaries around its output and its packed constants,
    checked after each of 20 launches); K4 also at the exact localization
    model's shape (m = 1000, d = 3, N = 65536 positions over the mapped
    area; the table form, one particle a block); K3 also at rw = 8 and
    40, at nl = 136 and at nl = 2048 (its wide form); K5 in each of its
    forms (P resident in the block, streamed, two passes), each launched
    twice for equal bits; the probes K8-K11 in bf16 at N=16384, nl=128
    and in f32 at N=4096, nl=512, with their cross-checks (K10 bit-equal
    to torch.index_select, K9 gather+dot to K3, K8 to K2 with Wt = 0, K9
    gather only to K10). K1, K4 and K7 in the form their planner picks,
    bit for bit against their direct form, are the ``gpu`` tests of
    tests/test_torch_kernels.py (-k "table or direct"). K2 and K3 at bf16,
    N=16384, nl=128 also at the sweep's factor widths rw = 12, 48, 96 and
    192, and K2 and K8 on the base indices of a recorded lowrank run
    (k2_main_path) at bf16, N=16384 and 131072, nl=128, and at f32,
    N=12288, nl=640 (the benchmark cell's shape): against the plain
    version, bit-equal between launches, with live rows, with bad indices
    inside runs, K8 against K2 with Wt = 0, and at f32 K2's own count of
    the P_base matrices it read against the host's count of its pieces;
 4. headline run of the port's filter: bean_6D, N_P=16384, m=125 (n_lin
    128), T=192, bf16 covariance, lowrank r=8, systematic resampling;
    check finiteness, the launch counts of every kernel and the position
    RMSE;
 5. the same path at the reference shape: N_P=4096, m=509, f32;
 4b/5b. the block_gather path (kernel K5 every step) at both shapes;
 4c. the xla path (the JAX package's default) at the headline shape with
    multinomial resampling every step (the reference's scheme);
 6. the filter on the card (kernels) against the same filter on the CPU
    (the wrappers' plain versions), N_P=64, m=125, T=24, f32, the same
    injected noise, on four paths (block_gather + systematic, xla +
    multinomial, lowrank + systematic with ESS gating at 0.7,
    block_gather + stratified with ESS gating at 0.7): equal ancestors,
    close estimates; and the smoothers likewise (N_P=24, T=12, 3 sweeps):
    radio run_rbps, radio run_rbps_information_form (woodbury and
    cholesky) and mag3d run_rbps_information_form; the batched EKF
    (B=3, m=64, T=24); the gridded terrain PF (N_P=4096, T=24, ESS gate
    0.5, the problem built on the card and copied); and the sparse filter
    (N_P=30) and CPF-AS smoother (N_P=10, 2 sweeps) on a six-landmark toy;
 7. the dense-radio workload at its reference size (line_3D, T=32,
    N_P=100, m=128, m_sim=2000, multinomial resampling, 20 sweeps):
    filter, then the CPF-AS smoother; again with the information-form
    smoother; every Jacobian through K6;
 8. the information-form smoother on the mag3d model at the reference
    bench row's size (N_P=100, m=512, T=192, 3 sweeps, systematic
    resampling, woodbury ancestor form, f32); every Jacobian through K4;
 9. the fused mag3d Jacobian in the transposed layout (K7) through its
    public entry, on the smoothed trajectory of phase 8;
11. the dense-mag workload at full width (m=512, n_lin 515, N_P=100,
    T=192, theta and Q of main.m): run_comparison with disturbances 0 and
    10, two runs each, 3 sweeps (PF and PS aligned RMSE under 0.6 m), and
    the batched EKF alone on twenty seeds' datasets (B=20, n=521);
12. the gridded terrain PF at bench.py's row (N_P=1,048,576, T=128, a
    192 x 192 grid, m_sim=512, systematic, ESS gate 0.5): finite ESS, no
    kernel launched, and no host-device sync in the step loop (a call
    site hit at every step);
13. the mag-localization workload at its reference size (N_P=1000,
    m=1000, m_sim=2000, ML-II on): the map's test RMSE (under 4.0) and
    the PF's mean error after burn-in (under 1.5 m); K4 and K12 launched
    once a weight evaluation each (160), no other kernel;
14. the sparse visual workload at its reference size (T=197, 20
    landmarks; PF N_P=100; PS N_K=10, N_P=10): path and map RMSE of both,
    no NaN, the PF's map under 2.0;
15. smoother resume at full width: run_rbps_information_form at phase 8's
    size, 2 sweeps with a checkpoint directory and then a resume to 3
    whose own generator is seeded otherwise (the CUDA generator's state
    comes from the checkpoint), bit-equal in every result field to phase
    8's unbroken run (K4 counted); then run_rbps (CPF-AS) on the radio
    problem at phase 7's size (m=128, N_P=100, T=32), 4 sweeps unbroken
    against 2 and a resume to 4 (K6 counted);
16. the engine's phase spans on the profiler's clock: one headline lowrank
    filter call (phase 4's configuration) inside ``trace_to`` and
    ``recording()``: the Chrome trace must name the spans and the kernels
    of K1-K3; each launch of K1, K2 and K3, found by its runtime call's
    correlation id, must start inside a ``jacobian``, ``update`` or
    ``rebase`` span (191, 191 and 24 launches) and the spans' launch
    counters must agree;
17. the command line: ``rbslam_tpu_torch.__main__.main(["dense-radio",
    "--quick"])`` in this process, on the card: finite RMSE lines, K6
    counted;
18. the mesh path (rbslam_tpu_torch/parallel) over a world-size-1 NCCL
    process group and mesh (1, 1): the headline xla filter with each
    dist_resampling mode against the unsharded run (K4 = 192, the
    collectives counted; local twice, bit-equal), and with joseph=True
    unsharded and on the mesh; the information-form smoother at phase 8's
    cell against phase 8's result (K4 = 578), and with checkpoints, 2
    sweeps and a resume to 3, bit-equal to its unbroken mesh run; the
    resamplers' CDF call to call (its bits must not move) beside a plain
    1-D torch.cumsum, the resamplers at N = 100, 16384 and 2^20 against a
    second call of themselves (0 flips), and the map-axis Woodbury
    transition and quadratic form (see phase_mesh);
19. the one-particle dense Kalman update (joseph off and on) against rows
    of the batched one at the headline shape, no kernel launched;
20. the headline lowrank filter with stratified resampling under an ESS
    gate of 0.5 (phase 4's launches, a finite result), and the mag3d
    information-form smoother at phase 8's cell with
    suffix_precompute=False (K4 = 3T+2, a finite XNK);
21. the reproduction scripts (rbslam_tpu_torch/reproduce) at full width
    and small depth: run_mc on line_3D and the JAX package's field (3
    runs, 5 sweeps; K6), run_boxplot_lowrank (K1-K4) and run_boxplot (K4),
    each with 2 seeds at o in {0, 10} and 2 sweeps: every key of the JAX
    package's results file, finite values and the launch counts; then
    compare.py's statistics against results/*.json, reported and not
    gated (the samples are too small to judge);
22. the benchmark entry point (rbslam_tpu_torch/bench.py): ``main(
    ["--quick"])`` (the card's stamp, bench.py's rows with its four keys,
    the quick filter's launches), then one run of bench.py's
    131,072-particle filter at full width (m=125, T=192, bf16, lowrank
    r=8, store_trajectories=False): phase 4's launches, a finite result,
    no history, position RMSE under the odometry's;
23. K12 gp_predictive (the exact localization weight's predictive) on a
    map fitted to seeded readings on the mapping path of
    workloads/mag_localization.py (m = 1000, theta of the benchmark's
    localization cell, no ML-II), at the cell's shape (N = 65,536
    positions over the mapped area: 196,608 rows of width 1003), at 512
    positions and at a ragged width (m = 997, 1001 positions: 3003 rows):
    against its plain version and, at the cell's shape, against a float64
    solve (tolerances in phase_predictive), two launches bit-equal.

Phase 10 (the kernel-part profile) is gone; the numbers of the others
stay.

Each run of phases 4, 5, 7, 8, 9, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
21 and 22 sets every launch count to 0 just before it and reads the counts
just after; the counts must be exactly those of its path (none for
12, 14 and 19, which are plain PyTorch, as the JAX package's paths are
plain XLA). No phase imports the viz package: the card's machine has no
matplotlib.

The second-to-last line is a JSON object with one entry per kernel: its
route, its source, the TPU kernel it replaces, its launches on its main
path (the probes K8-K11: their launches in phase 3) and its largest error
against its plain version in phase 3; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import datetime
import functools
import glob
import io
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from rbslam_tpu_torch.engines import (
    RBPFConfig,
    RBPSConfig,
    run_ekf_dense_batched,
    run_rbpf,
    run_rbps,
    run_rbps_information_form,
)
from rbslam_tpu_torch.kernels import (
    _lib,
    block_gather_plain,
    gather_cp,
    gather_cp_plain,
    gp_predictive,
    gp_predictive_plain,
    grad_basis,
    grad_basis_plain,
    kf_rebase,
    kf_update_block_gather,
    launch_counts,
    mag3d_jacobian,
    mag3d_jacobian_plain,
    mag3d_jacobian_rows,
    mag3d_jacobian_rows_plain,
    pack_basis_constants,
    pack_predictive,
    phi_basis,
    phi_basis_plain,
    probe_block_products,
    probe_block_products_plain,
    probe_gather,
    probe_gather_cp,
    probe_gather_cp_plain,
    probe_gather_plain,
    probe_rebase_parts,
    probe_rebase_parts_plain,
    rebase_plain,
    reset_launch_counts,
)
from rbslam_tpu_torch.kernels.basis_eval import _basis_plan
from rbslam_tpu_torch.kernels.kf_update import (
    _CP_RUN,
    _block_plan,
    _gather_cp_plan,
    _rebase_variant,
)
from rbslam_tpu_torch import bench
from rbslam_tpu_torch.basis import hypercube_basis
from rbslam_tpu_torch.basis.laplace import domain_center
from rbslam_tpu_torch.gp import fit_scalar_potential_gp
from rbslam_tpu_torch import __main__ as cli
from rbslam_tpu_torch.metrics import aligned_position_rmse
from rbslam_tpu_torch.utils import (
    ekf_inputs,
    latest_step,
    phase_annotation,
    recording,
    trace_to,
)
from rbslam_tpu_torch.workloads import (
    dense_mag,
    dense_radio,
    mag_localization,
    sparse_visual,
)
from rbslam_tpu_torch.reproduce import compare as verdicts
from rbslam_tpu_torch.reproduce import (
    run_boxplot,
    run_boxplot_lowrank,
    run_mc,
)
from rbslam_tpu_torch.models import PinholeCamera, make_pinhole2d_model
from rbslam_tpu_torch.models.pinhole2d import project
from rbslam_tpu_torch.workloads.dense_mag import build_problem

KERNELS = {
    "jac3d_rows": ("rbslam_tpu_torch/csrc/basis_eval.cu",
                   "rbslam_tpu/kernels/basis_eval.py:138"),
    "gather_cp": ("rbslam_tpu_torch/csrc/kf_update.cu",
                  "rbslam_tpu/kernels/kf_update.py:471"),
    "rebase": ("rbslam_tpu_torch/csrc/kf_update.cu",
               "rbslam_tpu/kernels/kf_update.py:659"),
    "grad_basis": ("rbslam_tpu_torch/csrc/basis_eval.cu",
                   "rbslam_tpu/kernels/basis_eval.py:64"),
    "block_gather": ("rbslam_tpu_torch/csrc/kf_update.cu",
                     "rbslam_tpu/kernels/kf_update.py:307"),
    "phi_basis": ("rbslam_tpu_torch/csrc/basis_eval.cu",
                  "rbslam_tpu/kernels/basis_eval.py:52"),
    "jac3d": ("rbslam_tpu_torch/csrc/basis_eval.cu",
              "rbslam_tpu/kernels/basis_eval.py:84"),
    "probe_gather_cp": ("rbslam_tpu_torch/csrc/probes.cu",
                        "scripts/profile_gather_cp.py:23"),
    "probe_rebase_parts": ("rbslam_tpu_torch/csrc/probes.cu",
                           "scripts/profile_rebase_parts.py:22"),
    "probe_gather": ("rbslam_tpu_torch/csrc/probes.cu",
                     "scripts/profile_gather_kernel.py:19"),
    "probe_block_products": ("rbslam_tpu_torch/csrc/probes.cu",
                             "scripts/profile_block_mxu.py:77"),
    "predictive": ("rbslam_tpu_torch/csrc/predictive.cu",
                   "none: the exact terrain weight's GP predictive "
                   "(rbslam_tpu/models/terrain.py leaves it to XLA)"),
}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def sync(device) -> None:
    torch.cuda.synchronize(device)


def compare(name, kernel, plain, device, dtype, shape_note, inputs,
            exact=False):
    """Run kernel and plain version on the same inputs (``inputs``: the
    tensors the kernel reads, named in a failure's message); check the
    error against the dtype's tolerance (relative to the output's max
    magnitude; in float32 also elementwise, rtol 1e-4 with an absolute
    floor of 1e-6 of that magnitude). ``dtype`` names the tolerance; None
    holds each output to the tolerance of its own dtype. A kernel with
    several outputs returns a tuple; a boolean output must be equal, and
    with ``exact`` every output. Returns {"max_abs_err": ...}."""
    outs_k = kernel()
    outs_p = plain()
    sync(device)
    if not isinstance(outs_k, tuple):
        outs_k, outs_p = (outs_k,), (outs_p,)
    err = 0.0
    for out_k, out_p in zip(outs_k, outs_p, strict=True):
        if out_k.shape != out_p.shape or out_k.dtype != out_p.dtype:
            raise AssertionError(
                f"{name}: kernel {tuple(out_k.shape)} {out_k.dtype} vs "
                f"plain {tuple(out_p.shape)} {out_p.dtype}"
            )
        if out_k.dtype == torch.bool or exact:
            if not torch.equal(out_k, out_p):
                raise AssertionError(f"{name} {shape_note}: outputs differ")
            if exact:
                log(f"[3] {name} {shape_note}: output {tuple(out_k.shape)} "
                    "bit-equal to the plain version")
            continue
        tol_dtype = out_k.dtype if dtype is None else dtype
        tol = TOL[tol_dtype]
        a, b = out_k.float(), out_p.float()
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: non-finite kernel output")
        e = float((a - b).abs().max())
        scale = float(b.abs().max())
        rel = e / max(scale, 1e-30)
        err = max(err, e)
        log(f"[3] {name} {shape_note}: output {tuple(a.shape)} "
            f"max_abs_err={e:.3e} rel={rel:.3e} (tol {tol:.0e})")
        if not rel <= tol:
            # the magnitudes say whether the outputs or the inputs went
            # wrong (one run of K1 at bf16 read max |plain| 6.5e4 where
            # valid inputs give at most 1)
            raise AssertionError(
                f"{name} {shape_note}: rel err {rel} > {tol}; max |kernel| "
                f"{float(a.abs().max()):.3e}, max |plain| {scale:.3e}, max "
                f"|input| {[float(t.float().abs().max()) for t in inputs]}")
        if tol_dtype == torch.float32 and not torch.allclose(
                a, b, rtol=TOL[torch.float32], atol=1e-6 * scale):
            raise AssertionError(
                f"{name} {shape_note}: elementwise error above rtol "
                f"{TOL[torch.float32]}, atol {1e-6 * scale:.3e}")
    return {"max_abs_err": err}


GUARD = 64          # canary elements on each side of a guarded buffer
CANARY = {torch.float32: -12288.0, torch.bfloat16: -12288.0,
          torch.int32: 0x5A5A5A5A}


def guarded(x):
    """``x`` copied into the middle of a buffer with GUARD canary elements
    on each side (64 elements keep the middle 16-byte aligned): (buffer,
    middle view)."""
    flat = x.reshape(-1)
    buf = torch.full((flat.numel() + 2 * GUARD,), CANARY[x.dtype],
                     dtype=x.dtype, device=x.device)
    buf[GUARD:GUARD + flat.numel()] = flat
    return buf, buf[GUARD:GUARD + flat.numel()].view(x.shape)


def k1_guard_bands(device, consts, pos, quat, nl, dtype, launches=20):
    """Phase 3, K1 between guard bands (the one-off fault of ROADMAP queue
    3: a K1 run at bf16 read max |kernel| 1.03e5 where valid inputs give at
    most 1). K1's output and its packed constants (``packed``, ``table``,
    ``col_codes``) each sit between canary values; before every launch the
    output is filled with the canary; after every launch (synchronized)
    the canaries must be intact, the constants unchanged, every output
    element written, and the output within the tolerance of the plain
    version. A failure names which of them moved."""
    bufs = {name: guarded(getattr(consts, name))
            for name in ("packed", "table", "col_codes")}
    originals = {name: getattr(consts, name).clone() for name in bufs}
    cc = consts._replace(**{name: view for name, (_, view) in bufs.items()})
    n = pos.shape[0]
    out_buf, out = guarded(torch.empty((n, 3, nl), dtype=dtype,
                                       device=device))
    plain = mag3d_jacobian_rows_plain(consts, pos, quat, nl, dtype).float()
    scale = float(plain.abs().max())
    worst = 0.0
    for i in range(launches):
        out.fill_(CANARY[dtype])
        mag3d_jacobian_rows(cc, pos, quat, nl, dtype, out=out)
        sync(device)
        moved = [f"{name} guard" for name, (buf, _) in
                 (*bufs.items(), ("output", (out_buf, None)))
                 if not (bool((buf[:GUARD] == CANARY[buf.dtype]).all())
                         and bool((buf[-GUARD:] == CANARY[buf.dtype]).all()))]
        moved += [name for name in bufs
                  if not torch.equal(bufs[name][1], originals[name])]
        if bool((out == CANARY[dtype]).any()):
            moved.append("output not all written")
        err = float((out.float() - plain).abs().max()) / max(scale, 1e-30)
        worst = max(worst, err)
        if moved or not err <= TOL[dtype]:
            raise AssertionError(
                f"K1 guard bands, launch {i + 1} of {launches} (N={n} "
                f"nl={nl} {dtype}): moved {moved}; rel err {err:.3e}; max "
                f"|kernel| {float(out.float().abs().max()):.3e}, max |plain| "
                f"{scale:.3e}")
    log(f"[3] K1 guard bands N={n} m={consts.m} nl={nl} {dtype}: {launches} "
        f"launches, each checked: canaries around the output and the packed "
        f"constants intact, constants unchanged, every output element "
        f"written, max rel err {worst:.3e} (tol {TOL[dtype]:.0e})")


def main_path_bases(device, n, m=125, dtype="bfloat16", T=192, r=8, ny=3):
    """The lowrank loop's K2 launches over one run of bench.py's filter at
    N_P = n, m basis functions and covariance dtype ``dtype``
    (``bench.rbpf_case``: bean_6D, r=8, seed 1): for each of the T - 1
    steps its base indices (arange at each rebase, composed with every
    step's systematic ancestors, as engines/rbpf.py does) and its live
    factor rows, ny times the steps since the rebase."""
    run, _, _ = bench.rbpf_case(m, n, T, device=device, cov_dtype=dtype,
                                kf_kernel="lowrank",
                                store_trajectories=False)
    anc = run(1).ancestors
    del run
    torch.cuda.empty_cache()
    steps = []
    for t in range(T - 1):
        if t % r == 0:
            b = torch.arange(n, dtype=torch.int32, device=device)
        b = b[anc[t].long()]
        steps.append((b, ny * (t % r)))
    return steps


def k2_pieces(b, n_base):
    """The P_base matrices K2's float32 form reads for base indices ``b``:
    its pieces, the runs of equal valid indices cut every _CP_RUN
    particles from the run's start (an index outside [0, n_base) reads
    nothing)."""
    ok = (b >= 0) & (b < n_base)
    start = torch.ones_like(ok)
    start[1:] = (b[1:] != b[:-1]) | ~ok[1:]
    idx = torch.arange(b.numel(), device=b.device)
    run0 = torch.cummax(torch.where(start, idx, torch.zeros_like(idx)), 0)[0]
    return int(((idx - run0) % _CP_RUN == 0).logical_and(ok).sum())


def plain_in_chunks(bidx, C, Wt, P_base, rows, chunk=1024):
    """gather_cp_plain a chunk of particles at a time (each particle's row
    is its own: the bits are those of one call), so that the gathered
    copy of P_base stays small at the float32 cell's 20 GB."""
    return torch.cat([gather_cp_plain(bidx[i:i + chunk], C[i:i + chunk],
                                      Wt[i:i + chunk], P_base, rows)
                      for i in range(0, bidx.shape[0], chunk)])


def k2_bad_index(note, bidx, C, Wt, P_base, rows, out):
    """Out-of-range base indices inside runs (and one outside) write NaN
    for those particles alone; every other row keeps the bits of ``out``."""
    n, n_base = bidx.shape[0], P_base.shape[0]
    inside = (torch.nonzero(bidx[1:] == bidx[:-1]).flatten() + 1)[:3].tolist()
    at = sorted({*inside, n // 2, n - 1})
    bad = bidx.clone()
    for j, i in enumerate(at):
        bad[i] = (-1, n_base, -7, n_base + 5)[j % 4]
    got = gather_cp(bad, C, Wt, P_base, rows)
    keep = torch.ones(n, dtype=torch.bool, device=bidx.device)
    keep[at] = False
    if not (bool(torch.isnan(got[at]).all())
            and torch.equal(got[keep], out[keep])):
        raise AssertionError(f"gather_cp {note}: bad indices at {at} do not "
                             "give NaN there alone")
    log(f"[3] gather_cp {note}: bad indices at {at} ({len(inside)} inside "
        f"runs of equal bases): NaN there, the other rows bit-equal")


def k2_main_path(device, g, n, m=125, dtype=torch.bfloat16, ny=3, rw=24):
    """Phase 3, K2 (and K8) on the main path's own indices at N_P = n, m
    basis functions (n_lin m + 3 padded to a multiple of 128, as the
    engine does) and covariance dtype ``dtype``: the 191 launches of one
    filter run (see main_path_bases), on random P_base, C and Wt. The 8
    steps of the last full rebase period (steps 176-183, the runs of equal
    bases longest at its end): against the plain version (the dtype's
    tolerance of the scale; at f32 also elementwise), a second launch
    bit-equal, ``rows`` bit-equal to all rows of a copy of Wt whose dead
    rows are zero; step 183 also with bad indices inside runs and K8,
    bit-equal to K2 with Wt = 0. At f32 the P_base matrices K2 counts
    (``recording()``, one span a launch) must equal the host's count of
    its pieces (k2_pieces) at every launch."""
    steps = main_path_bases(device, n, m, str(dtype).split(".")[1])
    nl = -(-(m + 3) // 128) * 128
    f32 = dtype == torch.float32
    P_base = torch.randn((n, nl, nl), generator=g, device=device).to(dtype)
    Wt = (0.1 * torch.randn((n, rw, nl), generator=g, device=device)
          ).to(dtype)
    C = (0.3 * torch.randn((n, ny, nl), generator=g, device=device)
         ).to(dtype)
    distinct = [int(torch.unique(b).numel()) for b, _ in steps]
    note = f"N={n} ny={ny} rw={rw} nl={nl} {str(dtype)[6:]} main-path indices"
    tol = TOL[dtype]
    for t in range(176, 184):
        b, rows = steps[t]
        out = gather_cp(b, C, Wt, P_base, rows)
        ref = plain_in_chunks(b, C, Wt, P_base, rows)
        scale = float(ref.abs().max())
        rel = float((out - ref).abs().max()) / scale
        if not (rel <= tol and bool(torch.isfinite(out).all())):
            raise AssertionError(f"gather_cp {note} step {t}: rel err {rel}")
        if f32 and not torch.allclose(out, ref, rtol=tol, atol=1e-6 * scale):
            raise AssertionError(f"gather_cp {note} step {t}: elementwise "
                                 f"error above rtol {tol}")
        if not torch.equal(out, gather_cp(b, C, Wt, P_base, rows)):
            raise AssertionError(f"gather_cp {note} step {t}: two launches "
                                 "differ")
        Wz = Wt.clone()
        Wz[:, rows:] = 0
        if not torch.equal(out, gather_cp(b, C, Wz, P_base)):
            raise AssertionError(f"gather_cp {note} step {t}: rows={rows} "
                                 "differs from all rows")
        del Wz, ref
        log(f"[3] gather_cp {note} step {t}: {distinct[t]} distinct of {n}, "
            f"rows={rows}: rel err {rel:.3e} (tol {tol:.0e}), two launches "
            f"bit-equal, bit-equal to all {rw} rows with the dead rows zero")
    b183 = steps[183][0]
    k2_bad_index(f"{note} step 183", b183, C, Wt, P_base, steps[183][1], out)
    Cf = C.float()
    k8 = probe_gather_cp(b183, Cf, P_base)
    if not torch.equal(k8, gather_cp(b183, C, torch.zeros_like(Wt),
                                     P_base)):
        raise AssertionError(f"probe_gather_cp {note} step 183: differs "
                             "from K2 with Wt = 0")
    log(f"[3] probe_gather_cp {note} step 183: bit-equal to K2 with Wt = 0")
    if not f32:
        compare("probe_gather_cp", lambda: probe_gather_cp(b183, Cf, P_base),
                lambda: probe_gather_cp_plain(b183, Cf, P_base), device,
                dtype, f"{note} step 183", (b183, Cf, P_base))
    del k8, Cf
    if f32:
        with recording() as rec:
            for b, rows in steps:
                with phase_annotation("k2"):
                    gather_cp(b, C, Wt, P_base, rows)
        counted = [s.k2_p_reads for s in rec.spans]
        want = [k2_pieces(b, n) for b, _ in steps]
        if counted != want:
            bad = [t for t, (c, w) in enumerate(zip(counted, want)) if c != w]
            raise AssertionError(
                f"gather_cp {note}: K2 counted {[counted[t] for t in bad[:4]]}"
                f" P_base reads at steps {bad[:4]}, its pieces are "
                f"{[want[t] for t in bad[:4]]}")
        log(f"[3] gather_cp {note}: K2's count of the P_base matrices it "
            f"read equals its pieces at each of the {len(steps)} launches: "
            f"{sum(want) / (n * len(steps)):.4f} a particle, distinct bases "
            f"{sum(distinct) / (n * len(steps)):.4f}")
    del P_base, Wt, C, steps


def k2_main_paths(device, g, ny=3, rw=24):
    """K2 and K8 on the main path's own indices (runs of equal bases, live
    factor rows 3 p) at the headline shape, at bench.py's 131k row (bf16,
    m=125) and at the float32 benchmark cell's shape (N_P = 12,288,
    m = 512, n_lin 640)."""
    for n, m, dtype in ((16384, 125, torch.bfloat16),
                        (131072, 125, torch.bfloat16),
                        (12288, 512, torch.float32)):
        k2_main_path(device, g, n, m, dtype, ny, rw)


def phase_compare(device, n=16384, m=125, nl=128, n_ref=4096, nl_ref=512,
                  ny=3, rw=24):
    """Phase 3: each kernel against its plain version on the card. The
    returned row of a kernel is the one at its main path's first shape.
    Returns (rows, the launch counts of the phase)."""
    reset_launch_counts()
    g = torch.Generator(device=device).manual_seed(0)
    bounds3 = [[-20.0, -20.0, -2.4], [20.0, 20.0, 2.4]]
    basis = hypercube_basis(m, bounds3)
    consts = pack_basis_constants(basis, device)
    pos = (torch.rand((n, 3), generator=g, device=device) - 0.5) \
        * torch.tensor([36.0, 36.0, 4.0], device=device)
    quat = torch.randn((n, 4), generator=g, device=device)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    rows = {}
    # per (particle, basis function): 3 phases (2), 3 sincos (2), 3
    # gradient rows (4), 3 rotated rows (5)
    ref = pack_basis_constants(hypercube_basis(nl_ref - 3, bounds3), device)
    pos_ref, quat_ref = pos[:n_ref], quat[:n_ref]
    jac_cases = ((consts, pos, quat, nl, torch.bfloat16),
                 (ref, pos_ref, quat_ref, nl_ref, torch.float32))
    for cc, pp, qq, nll, dt in jac_cases:
        r = compare(
            "jac3d_rows",
            lambda: mag3d_jacobian_rows(cc, pp, qq, nll, dt),
            lambda: mag3d_jacobian_rows_plain(cc, pp, qq, nll, dt),
            device, dt, f"N={pp.shape[0]} m={cc.m} nl={nll} {dt}",
            (pp, qq, cc.packed))
        rows.setdefault("jac3d_rows", r)
        k1_guard_bands(device, cc, pp, qq, nll, dt)
    # K4 at the headline shape, at d = 2, at the mag3d smoother's 100
    # particles (the direct form there) and at the exact localization
    # model's shape: m = 1000 on the domain of the benchmark's mapped area
    # ([-4, 4]^2 padded by 1.6), 65,536 centred positions over that area
    # (the table form, one particle a block; drawn from a generator of its
    # own, so the other cases' inputs stay as they were)
    d2 = pack_basis_constants(hypercube_basis(128, [9.0, 6.0]), device)
    x2 = (2 * torch.rand((n, 2), generator=g, device=device) - 1) \
        * torch.tensor([9.0, 6.0], device=device)
    smoother = pack_basis_constants(hypercube_basis(512, bounds3), device)
    loc = pack_basis_constants(
        hypercube_basis(1000, [[-5.6, -5.6, -1.6], [5.6, 5.6, 1.6]]), device)
    g_loc = torch.Generator(device=device).manual_seed(19)
    x_loc = (torch.rand((65536, 3), generator=g_loc, device=device) - 0.5) \
        * torch.tensor([8.0, 8.0, 0.2], device=device)
    if _basis_plan(False, 65536, 3, 1000, 0, 4, loc.counts) != (1, 1):
        raise AssertionError("K4 at N=65536 m=1000 d=3 does not plan the "
                             "table form at one particle a block")
    grad_cases = ((consts, pos), (d2, x2), (smoother, pos[:100]),
                  (loc, x_loc))
    for cc, xx in grad_cases:
        r = compare(
            "grad_basis", lambda: grad_basis(cc, xx),
            lambda: grad_basis_plain(cc, xx), device, torch.float32,
            f"N={xx.shape[0]} m={cc.m} d={cc.d} float32", (xx, cc.packed))
        rows.setdefault("grad_basis", r)

    # K7 against its plain version and against K1's float32 rows
    # transposed; at the headline and reference shapes and at phase 9's
    # (N=192, m=512, nl=640; the direct form there)
    for cc, pp, qq, nll in ((consts, pos, quat, nl),
                            (ref, pos_ref, quat_ref, nl_ref),
                            (smoother, pos[:192], quat[:192], 640)):
        nn, mm = pp.shape[0], cc.m
        r = compare(
            "jac3d", lambda: mag3d_jacobian(cc, pp, qq, nll),
            lambda: mag3d_jacobian_plain(cc, pp, qq, nll), device,
            torch.float32, f"N={nn} m={mm} nl={nll} float32",
            (pp, qq, cc.packed))
        rows.setdefault("jac3d", r)
        if not torch.equal(mag3d_jacobian(cc, pp, qq, nll),
                           mag3d_jacobian_rows(cc, pp, qq, nll)
                           .transpose(0, 1)):
            raise AssertionError("jac3d differs from jac3d_rows transposed")
        log(f"[3] jac3d N={nn} nl={nll}: bit-equal to jac3d_rows (float32) "
            "transposed")

    # K6 at the radio path's shape (N_P=100, d=2, m=128) and at large N;
    # two launches give the same bits
    for nn, dd, mm in ((100, 2, 128), (n, 2, 128), (n, 3, 512)):
        half = [9.0, 6.0, 2.4][:dd]
        cc = pack_basis_constants(hypercube_basis(mm, half), device)
        xx = (2 * torch.rand((nn, dd), generator=g, device=device) - 1) \
            * torch.tensor(half, device=device)
        note = f"N={nn} d={dd} m={mm} float32"
        r = compare(
            "phi_basis", lambda: phi_basis(cc, xx),
            lambda: phi_basis_plain(cc, xx), device, torch.float32, note,
            (xx, cc.packed))
        rows.setdefault("phi_basis", r)
        if not torch.equal(phi_basis(cc, xx), phi_basis(cc, xx)):
            raise AssertionError(f"phi_basis {note}: two launches differ")
        log(f"[3] phi_basis {note}: two launches bit-equal")

    def factored(nn, nll, dt, rww=rw):
        B = torch.randn((nn, nll, nll), generator=g, device=device)
        P_base = (0.05 * (B + B.transpose(1, 2))
                  + 2.0 * torch.eye(nll, device=device)).to(dt)
        del B
        Wt = (0.1 * torch.randn((nn, rww, nll), generator=g,
                                device=device)).to(dt)
        C = (0.3 * torch.randn((nn, ny, nll), generator=g,
                               device=device)).to(dt)
        bidx = torch.randint(0, nn, (nn,), generator=g, device=device,
                             dtype=torch.int32)
        return bidx, C, Wt, P_base

    for nn, nll, dt in ((n, nl, torch.bfloat16), (n_ref, nl_ref, torch.float32)):
        bidx, C, Wt, P_base = factored(nn, nll, dt)
        note = f"N={nn} ny={ny} rw={rw} nl={nll} {dt}"
        log(f"[3] {note}: {int(torch.unique(bidx).numel())} distinct of "
            f"{nn} random indices")
        r = compare("gather_cp", lambda: gather_cp(bidx, C, Wt, P_base),
                    lambda: gather_cp_plain(bidx, C, Wt, P_base),
                    device, torch.float32 if dt == torch.float32 else dt, note,
                    (bidx, C, Wt, P_base))
        rows.setdefault("gather_cp", r)
        if dt == torch.bfloat16:
            out = gather_cp(bidx, C, Wt, P_base)
            if not torch.equal(out, gather_cp(bidx, C, Wt, P_base)):
                raise AssertionError(f"gather_cp {note}: two launches differ")
            k2_bad_index(note, bidx, C, Wt, P_base, None, out)
            del out
        r = compare("rebase", lambda: kf_rebase(bidx, Wt, P_base),
                    lambda: rebase_plain(bidx, Wt, P_base), device, dt, note,
                    (bidx, Wt, P_base))
        rows.setdefault("rebase", r)
        del bidx, C, Wt, P_base

    # K2 and K3 at the factor widths rw = 3 r of the rebase-period sweep
    # (workloads/sweep_lowrank.py, r = 4, 16, 32, 64) at the headline shape
    for rww in (12, 48, 96, 192):
        bidx, C, Wt, P_base = factored(n, nl, torch.bfloat16, rww)
        note = (f"N={n} ny={ny} rw={rww} nl={nl} bfloat16 (K2 form "
                f"{_gather_cp_plan(ny, rww, nl, 2)}, K3 form "
                f"{_rebase_variant('kf_rebase', rww, nl, 2)})")
        compare("gather_cp", lambda: gather_cp(bidx, C, Wt, P_base),
                lambda: gather_cp_plain(bidx, C, Wt, P_base), device,
                torch.bfloat16, note, (bidx, C, Wt, P_base))
        out = gather_cp(bidx, C, Wt, P_base)
        if not torch.equal(out, gather_cp(bidx, C, Wt, P_base)):
            raise AssertionError(f"gather_cp {note}: two launches differ")
        k2_bad_index(note, bidx, C, Wt, P_base, None, out)
        del out
        compare("rebase", lambda: kf_rebase(bidx, Wt, P_base),
                lambda: rebase_plain(bidx, Wt, P_base), device,
                torch.bfloat16, note, (bidx, Wt, P_base))
        del bidx, C, Wt, P_base

    k2_main_paths(device, g, ny=ny, rw=rw)

    # K3 at other factor widths (the zero padding of rw to 16 at bf16), at
    # a map width that is no power of two (ragged row blocks and items) and
    # at nl = 2048, where the ring and the staged factor do not fit a block
    # and the wide form runs. Tolerances as everywhere (f32 1e-4, bf16 2e-2
    # of the scale): kernel and plain version differ in the order of the
    # f32 sum over rw products
    for nn, nll, rww in ((2048, 128, 8), (2048, 128, 40), (512, 512, 8),
                         (512, 512, 40), (1024, 136, 24), (64, 2048, 24)):
        for dt in (torch.bfloat16, torch.float32):
            P_base = torch.randn((nn, nll, nll), generator=g,
                                 device=device).to(dt)
            Wt = (0.1 * torch.randn((nn, rww, nll), generator=g,
                                    device=device)).to(dt)
            bidx = torch.randint(0, nn, (nn,), generator=g, device=device,
                                 dtype=torch.int32)
            compare("rebase", lambda: kf_rebase(bidx, Wt, P_base),
                    lambda: rebase_plain(bidx, Wt, P_base), device, dt,
                    f"N={nn} rw={rww} nl={nll} {dt}", (bidx, Wt, P_base))
            del P_base, Wt, bidx

    def block_inputs(nn, nyy, nll, dt):
        B = torch.randn((nn, nll, nll), generator=g, device=device)
        P = (0.05 * (B + B.transpose(1, 2))
             + 2.0 * torch.eye(nll, device=device)).to(dt)
        del B
        C = 0.3 * torch.randn((nn, nyy, nll), generator=g, device=device)
        xl = torch.randn((nn, nll), generator=g, device=device)
        y = torch.randn((nyy,), generator=g, device=device)
        R = 0.5 * torch.eye(nyy, device=device)
        ai = torch.randint(0, nn, (nn,), generator=g, device=device,
                           dtype=torch.int32)
        e = y[None] - torch.einsum("pij,pj->pi", C, xl)
        return ai, C, xl, P, y, R, e

    # K5 on random ancestors in each of its forms: P resident in the block
    # (the headline shape, and ny=1), streamed (bf16 beyond nl=128) and two
    # passes (the reference shape, f32 nl=1024); two launches give the same
    # bits
    for nn, nyy, nll, dt in ((n, ny, nl, torch.bfloat16),
                             (n_ref, ny, nl_ref, torch.float32),
                             (n, 1, nl, torch.float32),
                             (n_ref, ny, nl_ref, torch.bfloat16),
                             (256, ny, 1024, torch.float32),
                             (256, 1, 1024, torch.bfloat16)):
        ai, C, xl, P, y, R, e = block_inputs(nn, nyy, nll, dt)
        form = ("two passes", "resident", "streamed")[
            _block_plan(nyy, nll, P.element_size())[0]]
        note = f"N={nn} ny={nyy} nl={nll} {dt} ({form})"
        r = compare(
            "block_gather",
            lambda: kf_update_block_gather(ai, C, xl, P, y, R, 1e-3),
            lambda: block_gather_plain(ai, C, e, xl, P, R, 1e-3),
            device, None, note, (ai, C, xl, P, y, R))
        rows.setdefault("block_gather", r)
        first = kf_update_block_gather(ai, C, xl, P, y, R, 1e-3)
        second = kf_update_block_gather(ai, C, xl, P, y, R, 1e-3)
        if not all(torch.equal(a, b) for a, b in zip(first, second)):
            raise AssertionError(f"block_gather {note}: two launches differ")
        log(f"[3] block_gather {note}: two launches bit-equal")
        del ai, C, xl, P, y, R, e, first, second

    # the probes K8-K11 at the TPU scripts' shape (bf16) and at the
    # reference shape (f32), with their cross-checks
    for nn, nll, dt in ((n, nl, torch.bfloat16), (n_ref, nl_ref, torch.float32)):
        bidx, C_st, Wt, P = factored(nn, nll, dt)
        C = C_st.float()
        note = f"N={nn} ny={ny} rw={rw} nl={nll} {dt}"
        log(f"[3] {note}: {int(torch.unique(bidx).numel())} distinct of "
            f"{nn} random indices")
        r = compare("probe_gather_cp", lambda: probe_gather_cp(bidx, C, P),
                    lambda: probe_gather_cp_plain(bidx, C, P), device, dt,
                    note, (bidx, C, P))
        rows.setdefault("probe_gather_cp", r)
        for do_gather, do_dot in ((True, True), (True, False), (False, True),
                                  (False, False)):
            r = compare(
                "probe_rebase_parts",
                lambda: probe_rebase_parts(bidx, Wt, P, do_gather, do_dot),
                lambda: probe_rebase_parts_plain(bidx, Wt, P, do_gather,
                                                 do_dot),
                device, dt, f"{note} gather={do_gather} dot={do_dot}",
                (*((bidx,) if do_gather else ()), *((Wt,) if do_dot else ()),
                 P))
            rows.setdefault("probe_rebase_parts", r)      # the full variant
        r = compare("probe_gather", lambda: probe_gather(bidx, P),
                    lambda: probe_gather_plain(bidx, P), device, dt, note,
                    (bidx, P), exact=True)
        rows.setdefault("probe_gather", r)
        bidx64 = bidx.long()
        r = compare("probe_block_products",
                    lambda: probe_block_products(C, P),
                    lambda: probe_block_products_plain(C, P), device, dt, note,
                    (C, P))
        rows.setdefault("probe_block_products", r)
        checks = [
            ("K10 = torch.index_select",
             lambda: probe_gather(bidx, P),
             lambda: torch.index_select(P, 0, bidx64)),
            ("K9(gather, dot) = K3 kf_rebase",
             lambda: probe_rebase_parts(bidx, Wt, P, True, True),
             lambda: kf_rebase(bidx, Wt, P)),
            ("K8 = K2 gather_cp with Wt = 0",
             lambda: probe_gather_cp(bidx, C, P),
             lambda: gather_cp(bidx, C_st, torch.zeros_like(Wt), P)),
            ("K9(gather, no dot) = K10",
             lambda: probe_rebase_parts(bidx, Wt, P, True, False),
             lambda: probe_gather(bidx, P)),
        ]
        for what, fa, fb in checks:
            if not torch.equal(fa(), fb()):
                raise AssertionError(f"cross-check failed at {note}: {what}")
            log(f"[3] cross-check {note}: {what}: bit-equal")
        del bidx, C_st, C, Wt, P, checks
    return rows, launch_counts()


def filter_config(n_particles, cov_dtype, kf_kernel="lowrank",
                  resampling="systematic", ess_threshold=1.0):
    return RBPFConfig(
        n_particles=n_particles, resampling=resampling,
        cov_dtype=cov_dtype, symmetrize_cov=False, kf_kernel=kf_kernel,
        lowrank_period=8, ess_threshold=ess_threshold,
    )


def check_result(res, T, n_particles, n_lin):
    expect = {
        "traj_mean": (T, 7), "traj_max": (T, 7), "xl_mean": (n_lin,),
        "P_mean": (n_lin, n_lin), "logw": (n_particles,), "ess": (T,),
        "ancestors": (T - 1, n_particles),
        "xn_traj": (T, n_particles, 7),
    }
    for field, shape in expect.items():
        t = getattr(res, field)
        if tuple(t.shape) != shape:
            raise AssertionError(f"{field} shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{field} has non-finite values")
    if not bool(torch.isfinite(res.log_evidence)):
        raise AssertionError("log_evidence is not finite")


def run_path(tag, device, m, T, cfg, expect_counts):
    """Phases 4, 5 and their block_gather and xla variants: the port's
    filter at full width on the card (bean_6D, m_sim=512, seed 1), with
    its launch counts."""
    problem, data = build_problem(m, T, seed=1, m_sim=512, device=device)
    reset_launch_counts()
    res = run_rbpf(*problem.rbpf_args(), cfg,
                   generator=torch.Generator(device=device).manual_seed(0),
                   device=device)
    sync(device)
    counts = launch_counts()
    path = cfg.kf_kernel + (" r=8" if cfg.kf_kernel == "lowrank" else "")
    log(f"[{tag}] N_P={cfg.n_particles} m={m} (n_lin={m + 3}) T={T} "
        f"{cfg.cov_dtype} {path} {cfg.resampling}: launches in one run: "
        f"{counts}")
    check_result(res, T, cfg.n_particles, problem.potential.n_lin)
    if counts != expect_counts:
        raise AssertionError(f"launch counts {counts} != {expect_counts}")
    truth = torch.as_tensor(data.pos, dtype=torch.float32, device=device)
    rmse = float(torch.sqrt(torch.mean(
        torch.sum((res.traj_mean[:, :3] - truth) ** 2, dim=-1))))
    odo = torch.as_tensor(data.odometry_path[:, :3], dtype=torch.float32,
                          device=device)
    rmse_odo = float(torch.sqrt(torch.mean(
        torch.sum((odo - truth) ** 2, dim=-1))))
    log(f"[{tag}] position RMSE of traj_mean vs truth: {rmse:.4f} m "
        f"(dead-reckoned odometry: {rmse_odo:.4f} m); chol_retries="
        f"{int(res.chol_retries)}")
    return counts


def phase_plain_vs_kernel(device, m=125, n_particles=64, T=24):
    """Phase 6: the filter on the card, whose wrappers launch the kernels,
    against the same filter on the CPU, whose wrappers run the plain
    versions, with the same injected noise, on four paths. T=24: over the
    first 12 steps of this trajectory the ESS stays above 0.7 N (the
    particles barely differ yet), so a gated run would never resample;
    by step 24 it resamples on about a third of the steps."""
    cases = [
        ("block_gather", "systematic", 1.0),
        ("xla", "multinomial", 1.0),
        ("lowrank", "systematic", 0.7),
        ("block_gather", "stratified", 0.7),
    ]
    problems = {dev.type: build_problem(m, T, seed=1, m_sim=512,
                                        device=dev)[0]
                for dev in (device, torch.device("cpu"))}
    gen = torch.Generator(device=device).manual_seed(7)
    for kf_kernel, resampling, ess in cases:
        u_shape = (T - 1,) if resampling == "systematic" \
            else (T - 1, n_particles)
        u = torch.rand(u_shape, generator=gen, device=device)
        w = torch.randn((T - 1, n_particles, 6), generator=gen,
                        device=device)
        cfg = filter_config(n_particles, "float32", kf_kernel, resampling,
                            ess)
        out = {}
        for dev in (device, torch.device("cpu")):
            out[dev.type] = run_rbpf(*problems[dev.type].rbpf_args(), cfg,
                                     generator=None, device=dev,
                                     noise=(u.to(dev), w.to(dev)))
        sync(device)
        k, p = out[device.type], out["cpu"]
        note = (f"{kf_kernel} + {resampling}, ess_threshold={ess} "
                f"(N_P={n_particles}, m={m}, T={T}, f32)")
        if not torch.equal(k.ancestors.cpu(), p.ancestors):
            raise AssertionError(f"{note}: ancestors differ between kernel "
                                 "and plain path")
        resampled = sum(
            not torch.equal(a, torch.arange(n_particles, dtype=a.dtype))
            for a in p.ancestors)
        d_traj = float((k.traj_mean.cpu() - p.traj_mean).abs().max())
        d_xl = float((k.xl_mean.cpu() - p.xl_mean).abs().max())
        log(f"[6] {note}: card (kernels) vs cpu (plain versions): "
            f"ancestors equal ({resampled} of {T - 1} steps resampled), "
            f"max|d traj_mean|={d_traj:.3e} (tol 1e-3), "
            f"max|d xl_mean|={d_xl:.3e} (tol 5e-3)")
        if not (d_traj <= 1e-3 and d_xl <= 5e-3):
            raise AssertionError(f"{note}: kernel path and plain path "
                                 "disagree")
        if ess < 1.0 and not 0 < resampled < T - 1:
            raise AssertionError(f"{note}: the ESS gate should both skip "
                                 "and resample")


def phase_smoothers_plain_vs_kernel(device, n_particles=24, T=12, n_sweeps=3):
    """Phase 6, smoothers: each smoother on the card (kernels) against the
    same smoother on the CPU (plain versions) with the same injected
    noise: equal ancestors and kept trajectories, XNK within 1e-3, XLK
    within 5e-3."""
    cpu = torch.device("cpu")
    rcfg = dense_radio.DenseRadioConfig(n_steps=T, n_particles=n_particles,
                                        m_basis=32, m_sim=256)
    radio = {dev.type: dense_radio.build_problem(
        rcfg, torch.Generator().manual_seed(1), device=dev)[0]
        for dev in (device, cpu)}
    mag = {dev.type: build_problem(125, T, seed=1, m_sim=512, device=dev)[0]
           for dev in (device, cpu)}
    cases = [
        ("radio run_rbps", run_rbps, radio, "multinomial", {}),
        ("radio info-form woodbury", run_rbps_information_form, radio,
         "multinomial", {"ancestor_form": "woodbury"}),
        ("radio info-form cholesky", run_rbps_information_form, radio,
         "multinomial", {"ancestor_form": "cholesky"}),
        ("mag3d info-form woodbury", run_rbps_information_form, mag,
         "systematic", {"ancestor_form": "woodbury"}),
    ]
    gen = torch.Generator(device=device).manual_seed(11)
    for tag, fn, problems, resampling, kw in cases:
        n_noise = problems["cpu"].model.n_noise
        u_shape = (n_sweeps, T - 1) if resampling == "systematic" \
            else (n_sweeps, T - 1, n_particles)
        noise = (
            torch.rand(u_shape, generator=gen, device=device),
            torch.randn((n_sweeps, T - 1, n_particles, n_noise),
                        generator=gen, device=device),
            torch.rand((n_sweeps, T - 1), generator=gen, device=device),
            torch.rand((n_sweeps,), generator=gen, device=device),
        )
        cfg = RBPSConfig(n_particles=n_particles, n_sweeps=n_sweeps,
                         resampling=resampling, **kw)
        out = {}
        for dev in (device, cpu):
            out[dev.type] = fn(*problems[dev.type].rbpf_args(), cfg,
                               generator=None, device=dev,
                               noise=tuple(a.to(dev) for a in noise))
        sync(device)
        k, p = out[device.type], out["cpu"]
        if not (torch.equal(k.ancestors.cpu(), p.ancestors)
                and torch.equal(k.kept.cpu(), p.kept)):
            raise AssertionError(f"{tag}: ancestors or kept trajectories "
                                 "differ between card and cpu")
        d_xn = float((k.XNK.cpu() - p.XNK).abs().max())
        d_xl = float((k.XLK.cpu() - p.XLK).abs().max())
        log(f"[6] {tag} (N_P={n_particles}, T={T}, {n_sweeps} sweeps, "
            f"{resampling}): card (kernels) vs cpu (plain versions): "
            f"ancestors and kept trajectories equal, max|d XNK|={d_xn:.3e} "
            f"(tol 1e-3), max|d XLK|={d_xl:.3e} (tol 5e-3)")
        if not (d_xn <= 1e-3 and d_xl <= 5e-3):
            raise AssertionError(f"{tag}: card and cpu disagree")


def phase_ekf_plain_vs_card(device, B=3, m=64, T=24):
    """Phase 6, EKF: the batched EKF on the card against the same call on
    the CPU, on B seeds' datasets: x_traj within 1e-3, q_traj 1e-4."""
    out = {}
    for dev in (device, torch.device("cpu")):
        built = [build_problem(m, T, seed=1 + i, m_sim=256, device=dev)
                 for i in range(B)]
        problem, data = built[0]
        x0, q0, P0 = ekf_inputs(problem, domain_center(data.LL))
        out[dev.type] = run_ekf_dense_batched(
            problem.potential, torch.stack([b[0].dx for b in built]),
            torch.stack([b[0].y for b in built]), x0, q0, P0, problem.Q,
            problem.R, problem.dt, device=dev)
    sync(device)
    k, p = out[device.type], out["cpu"]
    d_x = float((k.x_traj.cpu() - p.x_traj).abs().max())
    d_q = float((k.q_traj.cpu() - p.q_traj).abs().max())
    log(f"[6] batched EKF (B={B}, m={m}, n={6 + 3 + m}, T={T}): card vs cpu: "
        f"max|d x_traj|={d_x:.3e} (tol 1e-3), max|d q_traj|={d_q:.3e} "
        f"(tol 1e-4), chol_retries {k.chol_retries.tolist()} / "
        f"{p.chol_retries.tolist()}")
    if not (d_x <= 1e-3 and d_q <= 1e-4
            and torch.equal(k.chol_retries.cpu(), p.chol_retries)):
        raise AssertionError("batched EKF: card and cpu disagree")


def phase_dense_mag(device, zero, n_sim=2, n_sweeps=3, n_ekf=20):
    """Phase 11: the dense-mag workload at full width through its entry
    points. K4 launches of run_comparison: per PF + PS run T = 192 (filter,
    xla path) + n_sweeps T + n_sweeps - 1 (smoother); the EKF launches no
    kernel (its Jacobian is plain torch, as in the JAX package)."""
    check_tf32_off()
    cfg = dense_mag.DenseMagConfig(n_sweeps=n_sweeps)
    T = cfg.n_laps * cfg.n_per_lap
    disturbances = (0.0, 10.0)
    expect = {**zero, "grad_basis": len(disturbances) * n_sim
              * (T + n_sweeps * T + n_sweeps - 1)}
    reset_launch_counts()
    out = dense_mag.run_comparison(cfg, disturbances, n_sim, device=device)
    sync(device)
    counts = launch_counts()
    log(f"[11] dense-mag run_comparison m={cfg.m_basis} (n_lin "
        f"{cfg.m_basis + 3}) N_P={cfg.n_particles} T={T} m_sim={cfg.m_sim} "
        f"{n_sweeps} sweeps, disturbances {disturbances}, n_sim={n_sim}: "
        f"launches {counts}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    for o, raw in out["raw"].items():
        log(f"[11] o={o}: aligned position RMSE ekf "
            f"{[round(v, 4) for v in raw['ekf']]} pf "
            f"{[round(v, 4) for v in raw['pf']]} ps "
            f"{[round(v, 4) for v in raw['ps']]} m; orientation RMSE pf "
            f"{[round(v, 4) for v in raw['pf_ori_deg']]} ps "
            f"{[round(v, 4) for v in raw['ps_ori_deg']]} deg")
        values = [v for vs in raw.values() for v in vs]
        if not all(v == v and abs(v) != float("inf") for v in values):
            raise AssertionError(f"o={o}: non-finite RMSE")
        if not max(raw["pf"] + raw["ps"]) < 0.6:
            raise AssertionError(f"o={o}: a PF or PS position RMSE is not "
                                 "under 0.6 m")

    # the batched EKF alone on n_ekf seeds' datasets
    built = [dense_mag.build_from_config(
        dense_mag.DenseMagConfig(seed=1 + i),
        torch.Generator().manual_seed(1 + i), device=device)
        for i in range(n_ekf)]
    problem, data = built[0]
    x0, q0, P0 = ekf_inputs(problem, domain_center(data.LL))
    reset_launch_counts()
    res = run_ekf_dense_batched(
        problem.potential, torch.stack([b[0].dx for b in built]),
        torch.stack([b[0].y for b in built]), x0, q0, P0, problem.Q,
        problem.R, problem.dt, device=device)
    sync(device)
    if launch_counts() != zero:
        raise AssertionError(f"the EKF launched kernels: {launch_counts()}")
    n = x0.shape[0]
    if tuple(res.x_traj.shape) != (n_ekf, T, n) \
            or tuple(res.P_final.shape) != (n_ekf, n, n) \
            or not bool(torch.isfinite(res.x_traj).all()) \
            or not bool(torch.isfinite(res.P_final).all()):
        raise AssertionError("batched EKF: wrong shape or non-finite values")
    rmse = [float(aligned_position_rmse(built[i][1].pos,
                                        res.x_traj[i, :, :3]))
            for i in range(n_ekf)]
    log(f"[11] run_ekf_dense_batched B={n_ekf} n={n} T={T}: chol_retries "
        f"{res.chol_retries.tolist()}")
    log(f"[11] EKF aligned position RMSE per member "
        f"{[round(v, 4) for v in rmse]} m")
    if not all(v == v and v < float("inf") for v in rmse):
        raise AssertionError("batched EKF: non-finite RMSE")
    return counts


def check_tf32_off():
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("matmul.allow_tf32 must stay off: the "
                             "smoothers maintain W by cancellation")


def phase_radio(device, zero):
    """Phase 7: the dense-radio workload at its reference size through its
    entry point, with each smoother. K6 launches: the filter T=32 times; a
    smoother T times per sweep plus once per sweep after the first for
    the reference trajectory's Jacobians, 20 * 32 + 19 = 659. Returns the
    launch counts of the last run."""
    check_tf32_off()
    for smoother in ("cpf_as", "info_form"):
        cfg = dense_radio.DenseRadioConfig(smoother=smoother)
        expect = {**zero, "phi_basis": cfg.n_steps
                  + cfg.n_sweeps * cfg.n_steps + cfg.n_sweeps - 1}
        reset_launch_counts()
        out = dense_radio.run(cfg, device=device)
        sync(device)
        counts = launch_counts()
        log(f"[7] dense-radio {cfg.traj_type} T={cfg.n_steps} "
            f"N_P={cfg.n_particles} m={cfg.m_basis} m_sim={cfg.m_sim} "
            f"{cfg.resampling} {cfg.n_sweeps} sweeps, smoother={smoother}: "
            f"launches {counts}")
        if counts != expect:
            raise AssertionError(f"launch counts {counts} != {expect}")
        sweeps = out["rmse_smoother_per_sweep"]
        log(f"[7] {smoother}: aligned RMSE filter max/mean "
            f"{out['rmse_filter_max_mean']} m; per sweep "
            f"{[round(r, 4) for r in sweeps]} m")
        values = out["rmse_filter_max_mean"] + sweeps
        if not all(v == v and abs(v) != float("inf") for v in values):
            raise AssertionError(f"{smoother}: non-finite RMSE")
        if not min(sweeps[1:]) < 0.6:
            raise AssertionError(f"{smoother}: best sweep {min(sweeps[1:])} "
                                 "m is not under 0.6 m")
    return counts


def phase_mag_smoother(device, zero, m=512, T=192, n_particles=100,
                       n_sweeps=3):
    """Phase 8: run_rbps_information_form at the reference bench row's
    size. K4 launches: T per sweep, plus once per sweep after the first
    for the reference trajectory, 3 * 192 + 2 = 578."""
    check_tf32_off()
    problem, data = build_problem(m, T, seed=1, m_sim=512, device=device)
    cfg = RBPSConfig(n_particles=n_particles, n_sweeps=n_sweeps,
                     resampling="systematic", ancestor_form="woodbury")
    expect = {**zero, "grad_basis": n_sweeps * T + n_sweeps - 1}
    reset_launch_counts()
    res = run_rbps_information_form(
        *problem.rbpf_args(), cfg,
        generator=torch.Generator(device=device).manual_seed(0),
        device=device)
    sync(device)
    counts = launch_counts()
    log(f"[8] launches in one run: {counts}")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    n_lin = problem.model.n_lin
    for field, shape in (("XNK", (n_sweeps, T, 7)), ("XLK", (n_sweeps, n_lin)),
                         ("PK", (n_sweeps, n_lin, n_lin)),
                         ("ess", (n_sweeps, T))):
        v = getattr(res, field)
        if tuple(v.shape) != shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{field}: shape {tuple(v.shape)} or "
                                 "non-finite values")
    rmse = [float(aligned_position_rmse(data.pos, res.XNK[k, :, :3]))
            for k in range(n_sweeps)]
    log(f"[8] info-form smoother N_P={n_particles} m={m} (n_lin={n_lin}) "
        f"T={T} {n_sweeps} sweeps woodbury f32 systematic: aligned position "
        f"RMSE per sweep {[round(r, 4) for r in rmse]} m; chol_retries "
        f"{res.chol_retries.tolist()}")
    return counts, problem, data, res


def phase_jac3d_entry(device, zero, problem, data, res):
    """Phase 9: K7 through its public entry, on the last sweep's
    trajectory: Ct [3, T, nl_pad] = R(q)^T [I | grad phi(p)] per step."""
    basis = problem.potential.basis
    consts = pack_basis_constants(basis, device)
    center = torch.as_tensor(domain_center(data.LL), dtype=torch.float32,
                             device=device)
    xnk = res.XNK[-1]
    nl_pad = -(-problem.model.n_lin // 128) * 128
    reset_launch_counts()
    Ct = mag3d_jacobian(consts, (xnk[:, :3] - center).contiguous(),
                        xnk[:, 3:7].contiguous(), nl_pad)
    sync(device)
    counts = launch_counts()
    if counts != {**zero, "jac3d": 1}:
        raise AssertionError(f"launch counts {counts}")
    if tuple(Ct.shape) != (3, xnk.shape[0], nl_pad) \
            or not bool(torch.isfinite(Ct).all()):
        raise AssertionError("jac3d: wrong shape or non-finite values")
    # the model's own Jacobian (K4 and a plain rotation) on the same states
    C = problem.model.meas_jacobian_batch(xnk)
    err = float((Ct[:, :, :C.shape[-1]].transpose(0, 1) - C).abs().max())
    log(f"[9] mag3d_jacobian on the smoothed trajectory: Ct "
        f"{tuple(Ct.shape)}, max|Ct - model Jacobian|={err:.3e} "
        f"(tol 1e-4 of {float(C.abs().max()):.3f}); launches {counts}")
    if not err <= 1e-4 * float(C.abs().max()):
        raise AssertionError("jac3d disagrees with the model's Jacobian")
    return counts


def phase_pf_plain_vs_card(device, n_particles=4096, T=24):
    """Phase 6, PF: the gridded terrain PF (systematic, ESS gate 0.5) on the
    card against the same filter on the CPU, the problem built once on the
    card and copied, the same injected draws: the ancestors equal up to
    the first knife-edge flip, traj_mean within 1e-3.

    The card's and the CPU's float32 log-weights differ in the last bits
    (exp, log and the sums round differently), so where n cdf_i - u0 lies
    within that rounding of an integer, systematic resampling puts one
    particle in the neighbouring bucket: one ancestor entry moves to the
    neighbouring index. At N = 4096 that happens on some runs (2 of 23
    steps in one H100 run); from there the two clouds differ in that
    particle, its weight shifts the later CDFs, and later steps may
    differ in many entries. So the check is: equal ancestors at every step
    before the first difference, and at that step at most two entries,
    each one index away; a fault in the port breaks the first resampling
    step in most entries."""
    problem = bench.build_terrain_problem(n_particles, T, device=device,
                                          seed=7)
    cfg = bench.terrain_config(n_particles)
    gen = torch.Generator(device=device).manual_seed(8)
    noise = (torch.rand(T - 1, generator=gen, device=device),
             torch.randn((T - 1, n_particles, 6), generator=gen,
                         device=device))
    k = problem.run(cfg, noise=noise)
    p = problem.to("cpu").run(cfg, noise=tuple(a.cpu() for a in noise))
    sync(device)
    first_ok, first, differ = first_flip_ok(k.ancestors.cpu(), p.ancestors)
    resampled = sum(not torch.equal(a, torch.arange(n_particles,
                                                    dtype=a.dtype))
                    for a in p.ancestors)
    d_traj = float((k.traj_mean.cpu() - p.traj_mean).abs().max())
    log(f"[6] terrain PF (N_P={n_particles}, T={T}, systematic, "
        f"ess_threshold=0.5): card vs cpu: ancestor entries differing by "
        f"step {differ.tolist()} ({resampled} of {T - 1} steps resampled; "
        f"first difference a knife-edge flip to a neighbouring index: "
        f"{'no difference' if first is None else first_ok}), max|d traj_mean|="
        f"{d_traj:.3e} (tol 1e-3)")
    if not (first_ok and d_traj <= 1e-3 and 0 < resampled < T - 1):
        raise AssertionError("terrain PF: card and cpu disagree")


def sparse_toy(device, n_landmarks=6, T=30, seed=3):
    """tests/test_engines_more.py:71-125's sparse problem, built by the port
    on ``device``: (model, dx, y, x0_nonlin, Q, R, landmarks)."""
    g = torch.Generator(device=device).manual_seed(seed)
    cam = PinholeCamera(f=1.5, fp=0.0, fw=1.0)
    landmarks = 4 * torch.rand((n_landmarks, 2), generator=g,
                               device=device) - 2
    th = torch.linspace(0, 2 * torch.pi, T, device=device)
    # the camera faces the circle's center (the reference test's heading
    # th + pi leaves 4 of 180 readings in view)
    truth = torch.stack([3 * torch.cos(th), 3 * torch.sin(th),
                         th + torch.pi / 2], dim=-1)
    y, not_visible = project(cam, truth, landmarks.expand(T, -1, -1))
    y = torch.where(not_visible, torch.nan, y) + 0.01 * torch.randn(
        (T, n_landmarks), generator=g, device=device)
    Q = torch.diag(torch.tensor([0.05**2, 0.05**2, 0.01**2], device=device))
    R = 0.01 * torch.eye(n_landmarks, device=device)
    return (make_pinhole2d_model(cam, n_landmarks), truth.diff(dim=0), y,
            truth[0], Q, R, landmarks)


def phase_sparse_plain_vs_card(device, n_pf=30, n_ps=10, n_sweeps=2):
    """Phase 6, sparse: the sparse filter and CPF-AS smoother on the card
    against the same calls on the CPU, on the toy problem with the same
    injected draws: equal ancestors (and kept trajectories), xl_mean within
    1e-4 and XNK within 1e-3."""
    check_tf32_off()
    cpu = torch.device("cpu")
    model, dx, y, x0, Q, R, landmarks = sparse_toy(device)
    T, M = y.shape
    g = torch.Generator(device=device).manual_seed(12)
    x0_lin = landmarks.reshape(-1) + 0.3 * torch.randn(
        (n_pf, 2 * M), generator=g, device=device)
    P0 = 0.5 * torch.eye(2 * M, device=device)
    f_noise = (torch.rand((T - 1, n_pf), generator=g, device=device),
               torch.randn((T - 1, n_pf, 3), generator=g, device=device))
    s_noise = (torch.rand((n_sweeps, T - 1, n_ps), generator=g,
                          device=device),
               torch.randn((n_sweeps, T - 1, n_ps, 3), generator=g,
                           device=device),
               torch.rand((n_sweeps, T - 1), generator=g, device=device),
               torch.rand((n_sweeps,), generator=g, device=device))
    out = {}
    for dev in (device, cpu):
        args = [model] + [a.to(dev) for a in (dx, y, x0)]
        rest = [P0.to(dev), Q.to(dev), R.to(dev), 1.0]
        out[dev.type] = (
            run_rbpf(*args, x0_lin.to(dev), *rest,
                     RBPFConfig(n_particles=n_pf), generator=None,
                     device=dev, noise=tuple(a.to(dev) for a in f_noise)),
            run_rbps(*args, x0_lin[:n_ps].to(dev), *rest,
                     RBPSConfig(n_particles=n_ps, n_sweeps=n_sweeps),
                     generator=None, device=dev,
                     noise=tuple(a.to(dev) for a in s_noise)))
    sync(device)
    (kf, ks), (pf, ps) = out[device.type], out["cpu"]
    d_xl = float((kf.xl_mean.cpu() - pf.xl_mean).abs().max())
    d_xn = float((ks.XNK.cpu() - ps.XNK).abs().max())
    log(f"[6] sparse filter (N_P={n_pf}, T={T}, {M} landmarks, "
        f"{int(torch.isnan(y).sum())} of {y.numel()} readings masked) and "
        f"CPF-AS (N_P={n_ps}, {n_sweeps} sweeps): card vs cpu: ancestors "
        f"equal {torch.equal(kf.ancestors.cpu(), pf.ancestors)} / "
        f"{torch.equal(ks.ancestors.cpu(), ps.ancestors)}, kept equal "
        f"{torch.equal(ks.kept.cpu(), ps.kept)}, max|d xl_mean|={d_xl:.3e} "
        f"(tol 1e-4), max|d XNK|={d_xn:.3e} (tol 1e-3)")
    if not (torch.equal(kf.ancestors.cpu(), pf.ancestors)
            and torch.equal(ks.ancestors.cpu(), ps.ancestors)
            and torch.equal(ks.kept.cpu(), ps.kept)
            and d_xl <= 1e-4 and d_xn <= 1e-3):
        raise AssertionError("sparse filter or smoother: card and cpu "
                             "disagree")


def phase_terrain_pf(device, zero, n_particles=1 << 20, T=128):
    """Phase 12: the gridded terrain PF at bench.py:127-195's row
    (``bench.build_terrain_problem``), one run under the sync counter:
    finite ESS, no kernel launched, and the host-device syncs by call site
    (``benchmark/trace.py::count_syncs``; a site hit at every step is in
    the step loop, and there must be none)."""
    from benchmark.trace import count_syncs

    problem = bench.build_terrain_problem(n_particles, T, device=device)
    cfg = bench.terrain_config(n_particles)
    gen = torch.Generator(device=device).manual_seed(0)

    out = []

    def run():
        out.append(problem.run(cfg, generator=gen))
        sync(device)

    reset_launch_counts()
    sites = count_syncs(run)
    res = out[0]
    counts = launch_counts()
    if counts != zero:
        raise AssertionError(f"the PF launched kernels: {counts}")
    resampled = sum(not torch.equal(a, torch.arange(n_particles,
                                                    device=device,
                                                    dtype=a.dtype))
                    for a in res.ancestors)
    if not (bool(torch.isfinite(res.ess).all())
            and bool(torch.isfinite(res.traj_mean).all())
            and bool(torch.isfinite(res.log_evidence))):
        raise AssertionError("terrain PF: non-finite ESS or estimates")
    err, err_end = bench.terrain_position_error(problem, res)
    in_loop = {k: v for k, v in sites.items() if v[0] >= T - 1}
    log(f"[12] gridded terrain PF N_P={n_particles} T={T} systematic "
        f"ess_threshold=0.5: launches {counts}; ESS min "
        f"{float(res.ess.min()):.1f} max {float(res.ess.max()):.1f}; "
        f"{resampled} of {T - 1} steps resampled; position error of "
        f"traj_mean after burn-in {err:.4f} m, last 5 steps {err_end:.4f} m; "
        f"host-device syncs in the run "
        f"{sum(n for n, _ in sites.values())} at {len(sites)} call sites, "
        f"{len(in_loop)} of them in the step loop")
    for site, (n, code) in sorted(sites.items(), key=lambda kv: -kv[1][0]):
        log(f"[12]   {n:6d}x {site}  {code[:80]}")
    if in_loop:
        raise AssertionError(f"host-device syncs in the step loop: {in_loop}")


def phase_mag_localization(device, zero):
    """Phase 13: the mag-localization workload at its reference size
    (N_P=1000, m=1000, m_sim=2000, ML-II on) through its entry point,
    held to the JAX test's gates (tests/test_workloads.py:44-58). The
    exact model's field rows come from K4, one launch a weight
    evaluation, and its predictive from K12, one launch a weight
    evaluation: T a run each, and no other kernel."""
    check_tf32_off()
    cfg = mag_localization.MagLocalizationConfig()
    reset_launch_counts()
    out = mag_localization.run(cfg, device=device)
    counts = launch_counts()
    if counts != {**zero, "grad_basis": cfg.n_test_steps,
                  "predictive": cfg.n_test_steps}:
        raise AssertionError(f"launched kernels: {counts}")
    gp, pf = out["gp"], out["pf"]
    log(f"[13] mag-localization ({out['data']}) N_P={cfg.n_particles} "
        f"m={cfg.m_basis} m_sim={cfg.m_sim} ML-II on: GP fit theta "
        f"{[round(v, 4) for v in gp['theta']]}, nll {gp['nll']:.2f}, map "
        f"test RMSE {gp['test_rmse']:.4f} (gate 4.0); PF mean error after "
        f"burn-in {pf['mean_err_after_burnin']:.4f} m (gate 1.5), final "
        f"{pf['final_err']:.4f} m, ESS min {pf['ess_min']:.1f}; launches "
        f"{counts}. The JAX package's recorded run: 2.12 / 0.10 m "
        "(RESULTS.md:53)")
    if not (gp["test_rmse"] < 4.0 and pf["mean_err_after_burnin"] < 1.5):
        raise AssertionError("mag-localization outside the JAX test's gates")
    return counts


def phase_sparse_visual(device, zero):
    """Phase 14: the sparse visual workload at its reference size (T=197,
    20 landmarks; PF N_P=100; PS N_K=10, N_P=10) through its entry
    point: path and map RMSE with no NaN, the PF's map under the JAX
    test's 2.0 (tests/test_workloads.py:21-30)."""
    check_tf32_off()
    reset_launch_counts()
    out = sparse_visual.run(sparse_visual.SparseVisualConfig(),
                            device=device)
    if launch_counts() != zero:
        raise AssertionError(f"launched kernels: {launch_counts()}")
    pf, ps = out["pf"], out["ps"]
    log(f"[14] sparse visual T={out['n_steps']}, {out['n_landmarks']} "
        f"landmarks: PF N_P=100 path / map RMSE {pf['rmse_path']:.4f} / "
        f"{pf['rmse_map']:.4f} (chol_retries {pf['chol_retries']}); PS "
        f"N_K=10 N_P=10 {ps['rmse_path']:.4f} / {ps['rmse_map']:.4f} "
        f"(chol_retries {ps['chol_retries']}). The JAX package's recorded "
        "run: PF 0.424 / 0.247, PS 0.393 / 0.244 (RESULTS.md:52)")
    values = [pf["rmse_path"], pf["rmse_map"], ps["rmse_path"],
              ps["rmse_map"]]
    if not all(v == v and abs(v) != float("inf") for v in values):
        raise AssertionError("sparse visual: non-finite RMSE")
    if not pf["rmse_map"] < 2.0:
        raise AssertionError("sparse visual: PF map RMSE not under 2.0")


def assert_bit_equal(tag, a, b):
    """Every field of two smoother results equal in dtype and bits."""
    for field, x, y in zip(a._fields, a, b):
        if x.dtype != y.dtype or not torch.equal(x, y):
            raise AssertionError(f"{tag}: {field} differs from the unbroken "
                                 "run")


def resumed_run(device, fn, args, cfg, n_first, seed, expect):
    """``fn`` for ``n_first`` sweeps with a checkpoint directory, then
    called again for ``cfg.n_sweeps`` with a generator seeded otherwise;
    the launch counts of the pair must be ``expect``. Returns (result,
    launch counts)."""
    gen = torch.Generator(device=device)
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as ck:
        fn(*args, cfg._replace(n_sweeps=n_first),
           generator=gen.manual_seed(seed), device=device, checkpoint_dir=ck)
        sync(device)
        if latest_step(ck) != n_first:
            raise AssertionError(f"no checkpoint of sweep {n_first}")
        res = fn(*args, cfg, generator=gen.manual_seed(seed + 1000),
                 device=device, checkpoint_dir=ck)
        sync(device)
        if latest_step(ck) != cfg.n_sweeps:
            raise AssertionError(f"no checkpoint of sweep {cfg.n_sweeps}")
    counts = launch_counts()
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    return res, counts


def phase_resume_info(device, zero, problem, res, n_first=2):
    """Phase 15, information form: phase 8's unbroken run (seed 0, 3
    sweeps) against 2 sweeps with a checkpoint directory and a resume to
    3. K4 launches of the pair: 2 * 192 + 1, then 192 + 1."""
    check_tf32_off()
    cfg = RBPSConfig(n_particles=100, n_sweeps=3, resampling="systematic",
                     ancestor_form="woodbury")
    T = problem.y.shape[0]
    expect = {**zero, "grad_basis": cfg.n_sweeps * T + cfg.n_sweeps - 1}
    out, counts = resumed_run(device, run_rbps_information_form,
                              problem.rbpf_args(), cfg, n_first, 0, expect)
    assert_bit_equal("info-form resume", res, out)
    log(f"[15] run_rbps_information_form N_P={cfg.n_particles} m="
        f"{problem.model.n_lin - 3} (n_lin={problem.model.n_lin}) T={T}: "
        f"{n_first} sweeps with checkpoints, then a resume to "
        f"{cfg.n_sweeps}; XNK, XLK, PK, ess, chol_retries, ancestors and "
        f"kept bit-equal to phase 8's unbroken run (CUDA generator restored "
        f"from the checkpoint); launches {counts}")


def phase_resume_radio(device, zero, n_sweeps=4, n_first=2, seed=3):
    """Phase 15, CPF-AS on the radio problem at phase 7's size (m=128,
    N_P=100, T=32): 4 sweeps unbroken against 2 with a checkpoint
    directory and a resume to 4. K6 launches: 4 * 32 + 3 each way."""
    check_tf32_off()
    rcfg = dense_radio.DenseRadioConfig()
    problem, _ = dense_radio.build_problem(
        rcfg, torch.Generator().manual_seed(rcfg.seed), device=device)
    cfg = RBPSConfig(n_particles=rcfg.n_particles, n_sweeps=n_sweeps,
                     resampling=rcfg.resampling)
    T = rcfg.n_steps
    expect = {**zero, "phi_basis": n_sweeps * T + n_sweeps - 1}
    reset_launch_counts()
    full = run_rbps(*problem.rbpf_args(), cfg,
                    generator=torch.Generator(device=device).manual_seed(seed),
                    device=device)
    sync(device)
    if launch_counts() != expect:
        raise AssertionError(f"launch counts {launch_counts()} != {expect}")
    out, counts = resumed_run(device, run_rbps, problem.rbpf_args(), cfg,
                              n_first, seed, expect)
    assert_bit_equal("radio CPF-AS resume", full, out)
    log(f"[15] run_rbps (CPF-AS) radio m={rcfg.m_basis} N_P="
        f"{rcfg.n_particles} T={T}: {n_sweeps} sweeps unbroken against "
        f"{n_first} with checkpoints and a resume to {n_sweeps}; every field "
        f"bit-equal; launches {counts} each way")


def phase_profiling(device, expect, n_particles=16384, m=125, T=192):
    """Phase 16: one headline lowrank filter call (phase 4's configuration)
    inside trace_to and recording(). The Chrome trace names the engine's
    spans and K1-K3. The shared clock: every K1, K2 and K3 launch, by the
    start of the runtime call with its correlation id, lies inside a
    ``jacobian``, ``update`` or ``rebase`` span, and those spans' launch
    counters hold every launch of their kernel."""
    from benchmark import spans as bench_spans
    from benchmark.roofline import family

    problem, _ = build_problem(m, T, seed=1, m_sim=512, device=device)
    cfg = filter_config(n_particles, "bfloat16")
    gen = torch.Generator(device=device).manual_seed(5)
    with tempfile.TemporaryDirectory() as logdir:
        reset_launch_counts()
        with trace_to(logdir) as prof, recording() as rec:
            t0 = time.perf_counter()
            run_rbpf(*problem.rbpf_args(), cfg, generator=gen, device=device)
            sync(device)
            wall = time.perf_counter() - t0
        counts = launch_counts()
        files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        if len(files) != 1:
            raise AssertionError(f"trace_to wrote {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")
    call = bench_spans.collect(rec.spans, prof, wall)
    owners = bench_spans.device_owners(call)
    where = {"K1": "jacobian", "K2": "update", "K3": "rebase"}
    counter = {"K1": "jac3d_rows", "K2": "gather_cp", "K3": "rebase"}
    found = {k: [] for k in where}
    for (name, *_), o in zip(call.device, owners):
        fam = family(name)
        if fam in found:
            found[fam].append(bench_spans.OUTSIDE if o == bench_spans.OUTSIDE
                              else rec.spans[o].name)
    log(f"[16] trace_to + recording() over one headline lowrank call: "
        f"{size} bytes of Chrome trace, {len(rec.spans)} spans, "
        f"{len(call.device)} device ops, {len(call.runtime)} runtime calls; "
        "K1-K3 launches by the span that holds their runtime call: "
        + ", ".join(f"{k} {dict(collections.Counter(v))}"
                    for k, v in found.items()) + f"; launches {counts}")
    for k, span in where.items():
        in_spans = sum(s.launches.get(counter[k], 0) for s in rec.spans
                       if s.name == span)
        if found[k] != [span] * expect[counter[k]] \
                or in_spans != expect[counter[k]]:
            raise AssertionError(
                f"{k}: launches by span {collections.Counter(found[k])}, "
                f"{in_spans} counted in {span} spans; expected "
                f"{expect[counter[k]]} in {span}")
    missing = {"rbpf", "step", "jacobian", "update", "rebase"} - names
    if missing or not any("gather_cp" in str(n) for n in names):
        raise AssertionError(f"the Chrome trace lacks {missing} or K2")


def phase_cli(device, zero):
    """Phase 17: ``python -m rbslam_tpu_torch dense-radio --quick``, in this
    process on the card. K6 launches: the filter T=32, three sweeps
    3 * 32 + 2."""
    expect = {**zero, "phi_basis": 32 + 3 * 32 + 2}
    out = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        cli.main(["dense-radio", "--quick"])
    sync(device)
    counts = launch_counts()
    report = json.loads(out.getvalue().strip().splitlines()[-1])
    values = report["rmse_filter_max_mean"] + report["rmse_smoother_per_sweep"]
    log(f"[17] python -m rbslam_tpu_torch dense-radio --quick on "
        f"{report['device']}: RMSE filter max/mean "
        f"{report['rmse_filter_max_mean']}, per sweep "
        f"{report['rmse_smoother_per_sweep']} m; launches {counts}")
    if report["device"] != torch.cuda.get_device_name(device):
        raise AssertionError("the CLI did not run on the card")
    if not all(math.isfinite(v) for v in values):
        raise AssertionError("the CLI's RMSE is not finite")
    if counts != expect:
        raise AssertionError(f"launch counts {counts} != {expect}")

def first_flip_ok(a_k, a_p, max_entries=2, max_move=1):
    """Ancestors [T-1, N] of a run against a reference run: equal at every
    step before the first difference, and at that step at most
    ``max_entries`` entries, each at most ``max_move`` indices away: a
    float32 knife-edge flip of systematic resampling moves a child past
    the particles whose CDF steps lie within rounding of its comb position
    (by default one entry to a neighbour, phase 6's rule). Returns (ok,
    first differing step or None, entries differing by step)."""
    a_k, a_p = a_k.long(), a_p.long()
    differ = (a_k != a_p).sum(dim=1)
    steps = torch.nonzero(differ).flatten().tolist()
    if not steps:
        return True, None, differ
    s0 = steps[0]
    ok = (int(differ[s0]) <= max_entries
          and bool(((a_k[s0] - a_p[s0]).abs() <= max_move).all()))
    return ok, s0, differ


def knife_edges(u, w, scheme, out, ref, tol=5e-7):
    """Children whose ancestor differs between two inverse-CDF resamplers
    of the same weights and uniforms: (count, largest distance in float64
    between the child's comb position and the CDF steps between the two
    answers). A flip is a knife edge where that distance is within
    float32 rounding (``tol``, about 8 units in the last place at 1)."""
    d = out.long() != ref.long()
    if not bool(d.any()):
        return 0, 0.0
    n = w.shape[0]
    cdf = torch.cumsum(w.double(), dim=0)
    cdf = cdf / cdf[-1]
    ar = torch.arange(n, dtype=torch.float64, device=w.device)
    q = {"systematic": lambda: (ar + u.double()) / n,
         "stratified": lambda: (ar + u.double()) / n,
         "multinomial": lambda: u.double()}[scheme]()[d]
    lo = torch.minimum(out.long(), ref.long())[d]
    hi = torch.maximum(out.long(), ref.long())[d]
    dist = torch.maximum((q - cdf[lo]).abs(), (q - cdf[hi - 1]).abs())
    return int(d.sum()), float(dist.max())


def plain_resample(u, w, n, scheme):
    """The stratified or multinomial resampler as it summed before the
    fixed-order CDF: a plain 1-D torch.cumsum, whose order on the card
    may change from call to call (the control of phase 18c)."""
    cdf = torch.cumsum(w, dim=0)
    cdf = cdf / cdf[-1]
    q = u[:n] if scheme == "multinomial" else \
        (torch.arange(n, dtype=w.dtype, device=w.device) + u[:n]) / n
    return torch.clamp(torch.searchsorted(cdf, q, right=True), 0,
                       w.shape[0] - 1)


def mesh_counts(n_steps, mode, symmetrize=False):
    """The collectives of one run_rbpf call on the xla path over a mesh
    (engines/rbpf.py, parallel/): per step the resampler's (replicated_cdf:
    one all-gather of the weights; prefix: one of the shard sums and one
    reduce-scatter; local: none), three ancestor gathers (xn, xl, P), P C'
    over the map, the log-weights' all-gather, one all-reduce (best row
    with the weighted mean) and, symmetrized, one all-to-all; step 0 two
    all-gathers; after the loop four all-gathers (history, ancestors,
    P_mean's and P_max's rows) and seven all-reduces. Returns (a step's,
    the run's)."""
    per = {"all_reduce": 1, "all_gather": 5 + (mode != "local"),
           "reduce_scatter": int(mode == "prefix"),
           "all_to_all": int(symmetrize)}
    fixed = {"all_reduce": 7, "all_gather": 6, "reduce_scatter": 0,
             "all_to_all": int(symmetrize)}
    return per, {k: per[k] * n_steps + fixed[k] for k in per}


def info_mesh_counts(T, n_sweeps):
    """The collectives of one run_rbps_information_form call (woodbury,
    symmetrized) over a mesh. Each sweep: at step 0 P C' over the map, the
    symmetrization's all-to-all and the log-weights' all-gather; per
    transition the resampler's all-gather, five ancestor gathers (xn, xl,
    P, ivec, hldp), P C' and the all-to-all, the log-weights; after the
    first sweep also the rows of the two initial factorizations (one
    all-reduce), and per transition two more ancestor gathers (W, hldM),
    the future weights' quadratic forms (one all-reduce), their
    normalization (one all-gather) and two Woodbury transitions (an
    all-reduce and an all-gather each);
    at the end the history, the ancestors and the kept map's rows (three
    all-gathers) and three all-reduces (its xl and P rows, the retries)."""
    steps = T - 1
    out = {"all_reduce": 0, "all_gather": 0, "reduce_scatter": 0,
           "all_to_all": 0}
    for k in range(n_sweeps):
        later = k > 0
        out["all_gather"] += 2 + (8 + 5 * later) * steps + 3
        out["all_reduce"] += later + 3 * later * steps + 3
        out["all_to_all"] += 1 + steps
    return out


def phase_mesh(device, zero, problem8, res8, n_particles=16384, m=125,
               T=192, n_res=1 << 20, n_wood=100, nl_wood=512, cdf_calls=20):
    """Phase 18: the mesh path (rbslam_tpu_torch/parallel) on this card, a
    world-size-1 NCCL process group (FileStore rendezvous in a
    temporary directory, destroyed at the end of the phase) and mesh (1,
    1). Two ranks cannot share a card under NCCL, so the cross-rank
    equivalence is the CPU tests' (tests/test_torch_parallel.py, gloo);
    here every collective runs, on groups of one rank.

    (a) run_rbpf at the headline shape on the xla path (bf16, systematic)
        with each dist_resampling mode against the unsharded xla run of the
        same generator seed: replicated_cdf and prefix ancestors equal up
        to the first knife-edge flip and traj_mean within 1e-5 of its
        scale before it; local: every child on its shard and the position
        RMSE below the dead-reckoned odometry's; K4 = 192 and the
        collectives (mesh_counts) per run. A second local run of the same
        seed is bit-equal to the first. Then joseph=True (ops/kalman.py's
        row-block Joseph form), unsharded and on the mesh, the mesh run
        against the unsharded one as prefix's.
    (b) run_rbps_information_form at phase 8's cell (woodbury, f32, seed
        0) against phase 8's unsharded result: XNK 1e-4, XLK 1e-3; K4 =
        578. Then 2 sweeps with a checkpoint directory and a resume to 3
        (a generator seeded otherwise): every field bit-equal to that
        mesh run, K4 = 578 for the pair.
    (c) the CDF of ops/resampling.py (_cumsum_1d) at 100 to 2^24 entries,
        twenty more calls each: its bits must not move (a plain 1-D
        torch.cumsum's moves are printed beside it); resample_indices
        stratified and multinomial at N = 100, 16384 and 2^20 against a
        second call of itself: 0 flips (the plain cumsum's inverse CDF
        printed beside it); at 2^20
        each scheme's resample_indices and sharded_resample_local against
        a second call (0 flips), and sharded_resample_indices in both
        modes against resample_indices (replicated_cdf 0 flips, prefix
        knife edges only) and against a second call of itself (0).
    (d) woodbury_rank_ny_rowsharded and quad_form_rowsharded at N=100,
        nl=512 against rbps_info._woodbury_rank_ny and v' W v.
    """
    import torch.distributed as dist

    from rbslam_tpu_torch.engines.rbps_info import _woodbury_rank_ny
    from rbslam_tpu_torch.ops.resampling import _cumsum_1d, resample_indices
    from rbslam_tpu_torch.parallel import (
        collective_counts,
        make_mesh,
        quad_form_rowsharded,
        reset_collective_counts,
        sharded_resample_indices,
        sharded_resample_local,
        woodbury_rank_ny_rowsharded,
    )

    store = tempfile.mkdtemp()
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = make_mesh(1, 1, device_type=device.type)
        log(f"[18] NCCL process group of world size "
            f"{dist.get_world_size()}, mesh {tuple(mesh.mesh.shape)} "
            f"{mesh.mesh_dim_names} on {device.type}")

        # (a) the headline xla filter in each resampling mode
        problem, data = build_problem(m, T, seed=1, m_sim=512, device=device)
        truth = torch.as_tensor(data.pos, dtype=torch.float32, device=device)
        odo = torch.as_tensor(data.odometry_path[:, :3], dtype=torch.float32,
                              device=device)
        gen = torch.Generator(device=device)
        expect_k = {**zero, "grad_basis": T}

        def run(mode, seed, joseph=False):
            gen.manual_seed(seed)
            cfg = filter_config(n_particles, "bfloat16", "xla")._replace(
                dist_resampling=mode or "replicated_cdf", joseph=joseph)
            res = run_rbpf(*problem.rbpf_args(), cfg, generator=gen,
                           device=device, mesh=mesh if mode else None)
            sync(device)
            return res

        def flips_note(res, ref):
            """(ok, note): ancestors equal up to the first knife-edge flip
            (room for 0.5 % of the entries, each at most 8 indices away) and
            traj_mean within 1e-5 of its scale up to there."""
            ok, s0, differ = first_flip_ok(res.ancestors, ref.ancestors,
                                           max(2, n_particles // 200), 8)
            upto = T if s0 is None else s0 + 1
            scale = float(ref.traj_mean[:upto].abs().max())
            d = float((res.traj_mean[:upto] - ref.traj_mean[:upto])
                      .abs().max())
            where = ("equal at every step" if s0 is None else
                     f"equal up to step {s0}, then {int(differ[s0])} entries")
            note = (f"ancestors {where}"
                    f" ({int((differ > 0).sum())} of {T - 1} steps "
                    f"differ); max|d traj_mean| {d:.3e} up to there "
                    f"(scale {scale:.3e}, tol 1e-5 of it); bit-equal "
                    f"traj_mean: {torch.equal(res.traj_mean, ref.traj_mean)}")
            return ok and d <= 1e-5 * scale, note

        def rmse(path):
            return float(torch.sqrt(torch.mean(torch.sum(
                (path[:, :3] - truth) ** 2, dim=-1))))

        ref = run(None, 0)
        log(f"[18a] unsharded xla N_P={n_particles} m={m} T={T} bf16 "
            f"systematic: position RMSE {rmse(ref.traj_mean):.4f} m "
            f"(odometry {rmse(odo):.4f} m)")
        for mode in ("replicated_cdf", "prefix", "local"):
            reset_launch_counts()
            reset_collective_counts()
            res = run(mode, 0)
            counts, coll = launch_counts(), collective_counts()
            check_result(res, T, n_particles, problem.potential.n_lin)
            per, want = mesh_counts(T - 1, mode)
            log(f"[18a] {mode}: launches {counts}; collectives {coll} "
                f"(a step: {per})")
            if counts != expect_k:
                raise AssertionError(f"launch counts {counts} != {expect_k}")
            if coll != want:
                raise AssertionError(f"collectives {coll} != {want}")
            if mode == "local":
                anc = res.ancestors.long()
                if not bool(((anc >= 0) & (anc < n_particles)).all()):
                    raise AssertionError("local: a child left its shard")
                # the accuracy guard (PERF.md §2): better than dead
                # reckoning; and a second call of the same seed gives the
                # same run (the island comb's CDF sums in a fixed order)
                again = run(mode, 0)
                same = (torch.equal(again.traj_mean, res.traj_mean)
                        and torch.equal(again.ancestors, res.ancestors))
                del again
                r, r_odo = rmse(res.traj_mean), rmse(odo)
                d = float((res.traj_mean[:, :3] - ref.traj_mean[:, :3])
                          .abs().max())
                note = (f"every child on its shard; position RMSE {r:.4f} m "
                        f"(unsharded {rmse(ref.traj_mean):.4f}, odometry "
                        f"{r_odo:.4f}: guard, below it); max|d position| "
                        f"from the unsharded run {d:.4f} m; a second call: "
                        f"traj_mean and ancestors bit-equal {same}")
                if not (math.isfinite(r) and r < r_odo and same):
                    raise AssertionError(f"local: {note}")
            else:
                # the CDF is summed in another order (prefix)
                ok, note = flips_note(res, ref)
                if not ok:
                    raise AssertionError(f"{mode}: {note}")
            log(f"[18a] {mode}: {note}")

        # (a') the Joseph form, unsharded and then on the mesh (its row-block
        # form, ops/kalman.py::_finish): the same launches and collectives,
        # the mesh run against the unsharded one as replicated_cdf above
        jref = None
        for mode in (None, "replicated_cdf"):
            reset_launch_counts()
            reset_collective_counts()
            res = run(mode, 0, joseph=True)
            counts, coll = launch_counts(), collective_counts()
            check_result(res, T, n_particles, problem.potential.n_lin)
            if counts != expect_k:
                raise AssertionError(f"Joseph: launch counts {counts} != "
                                     f"{expect_k}")
            if mode is None:
                jref = res
                note = (f"position RMSE {rmse(res.traj_mean):.4f} m (without "
                        f"Joseph {rmse(ref.traj_mean):.4f}, odometry "
                        f"{rmse(odo):.4f})")
                if not rmse(res.traj_mean) < rmse(odo):
                    raise AssertionError(f"Joseph: {note}")
            else:
                want = mesh_counts(T - 1, mode)[1]
                if coll != want:
                    raise AssertionError(f"Joseph collectives {coll} != "
                                         f"{want}")
                ok, note = flips_note(res, jref)
                note = f"against the unsharded Joseph run: {note}"
                if not ok:
                    raise AssertionError(f"Joseph on the mesh: {note}")
            log(f"[18a] joseph=True {mode or 'unsharded'}: launches {counts}; "
                f"{note}")
        del problem, data, ref, res, jref

        # (b) the information-form smoother at phase 8's cell
        cfg = RBPSConfig(n_particles=100, n_sweeps=3, resampling="systematic",
                         ancestor_form="woodbury")
        T8 = problem8.y.shape[0]
        expect_s = {**zero, "grad_basis": cfg.n_sweeps * T8
                    + cfg.n_sweeps - 1}
        reset_launch_counts()
        reset_collective_counts()
        out = run_rbps_information_form(
            *problem8.rbpf_args(), cfg,
            generator=torch.Generator(device=device).manual_seed(0),
            device=device, mesh=mesh)
        sync(device)
        counts, coll = launch_counts(), collective_counts()
        d_xn = float((out.XNK - res8.XNK).abs().max())
        d_xl = float((out.XLK - res8.XLK).abs().max())
        log(f"[18b] run_rbps_information_form on the mesh, N_P=100 n_lin="
            f"{problem8.model.n_lin} T={T8} 3 sweeps woodbury f32: "
            f"against phase 8's unsharded run max|d XNK| {d_xn:.3e} (tol "
            f"1e-4), max|d XLK| {d_xl:.3e} (tol 1e-3), bit-equal XNK: "
            f"{torch.equal(out.XNK, res8.XNK)}; launches {counts}; "
            f"collectives {coll}")
        if counts != expect_s:
            raise AssertionError(f"launch counts {counts} != {expect_s}")
        if not (d_xn <= 1e-4 and d_xl <= 1e-3):
            raise AssertionError("the sharded smoother disagrees with "
                                 "phase 8's")
        want = info_mesh_counts(T8, cfg.n_sweeps)
        if coll != want:
            raise AssertionError(f"collectives {coll} != {want}")
        # (b') per-sweep checkpoints on the mesh: 2 sweeps, then a resume to
        # 3 with a generator seeded otherwise, bit-equal to the run above
        res_ck, counts = resumed_run(
            device, functools.partial(run_rbps_information_form, mesh=mesh),
            problem8.rbpf_args(), cfg, 2, 0, expect_s)
        assert_bit_equal("[18b] the resumed mesh smoother", res_ck, out)
        log(f"[18b] on the mesh, 2 sweeps with checkpoints and a resume to "
            f"3: every field bit-equal to the unbroken mesh run; launches "
            f"{counts}")
        del res_ck

        # (c) the CDF every resampler sums with (ops/resampling.py::
        # _cumsum_1d), call to call, beside a plain 1-D torch.cumsum: its
        # bits must not move; then the resamplers, each against a second
        # call of itself (0 flips), and the sharded ones at 2^20
        g = torch.Generator(device=device).manual_seed(18)
        for n in (100, 1000, 4095, 4096, 16384, n_res, 1 << 24):
            x = torch.rand(n, generator=g, device=device)
            first_new, first_old = _cumsum_1d(x), torch.cumsum(x, dim=0)
            moved_new = sum(not torch.equal(_cumsum_1d(x), first_new)
                            for _ in range(cdf_calls))
            moved_old = sum(not torch.equal(torch.cumsum(x, dim=0), first_old)
                            for _ in range(cdf_calls))
            log(f"[18c] the CDF of {n} uniforms, {cdf_calls} more calls: its "
                f"bits moved in {moved_new} (a plain 1-D torch.cumsum's in "
                f"{moved_old})")
            if moved_new:
                raise AssertionError(f"the CDF of {n} entries moved")
        del x, first_new, first_old
        for n in (100, 16384, n_res):
            w = torch.softmax(2 * torch.randn(n, generator=g, device=device),
                              dim=0)
            for scheme in ("stratified", "multinomial"):
                u = torch.rand(n, generator=g, device=device)
                ai = resample_indices(u, w, n, scheme)
                flips = knife_edges(u, w, scheme,
                                    resample_indices(u, w, n, scheme), ai)[0]
                old = plain_resample(u, w, n, scheme)
                flips_old, dist_old = knife_edges(
                    u, w, scheme, plain_resample(u, w, n, scheme), old)
                log(f"[18c] resample_indices {scheme} N={n} against a "
                    f"second call: {flips} flips (the plain cumsum's inverse "
                    f"CDF: {flips_old}, largest distance {dist_old:.2e})")
                if flips:
                    raise AssertionError(f"resample_indices {scheme} N={n} "
                                         "is not reproducible")
        w = torch.softmax(2 * torch.randn(n_res, generator=g, device=device),
                          dim=0)
        for scheme in ("systematic", "stratified", "multinomial"):
            u = torch.rand(() if scheme == "systematic" else (n_res,),
                           generator=g, device=device)
            ref_ai = resample_indices(u, w, n_res, scheme)
            again = knife_edges(u, w, scheme,
                                resample_indices(u, w, n_res, scheme),
                                ref_ai)[0]
            island = sharded_resample_local(u, w, mesh, scheme)[0]
            island_again = knife_edges(
                u, w, scheme, sharded_resample_local(u, w, mesh, scheme)[0],
                island)[0]
            log(f"[18c] {scheme} N={n_res}, a second call: resample_indices "
                f"{again} flips, sharded_resample_local {island_again}")
            if again or island_again:
                raise AssertionError(f"{scheme}: a second call flipped")
            for mode in ("replicated_cdf", "prefix"):
                reset_collective_counts()
                out_ai = sharded_resample_indices(u, w, mesh, scheme, mode)
                sync(device)
                flips, dist_max = knife_edges(u, w, scheme, out_ai, ref_ai)
                coll = collective_counts()
                own = knife_edges(u, w, scheme, sharded_resample_indices(
                    u, w, mesh, scheme, mode), out_ai)[0]
                log(f"[18c] sharded_resample_indices {mode} {scheme} N="
                    f"{n_res}: {flips} knife-edge flips against "
                    f"resample_indices (largest distance of a flipped comb "
                    f"position from a CDF step {dist_max:.2e}, tol 5e-7), "
                    f"{own} against a second call of itself; collectives "
                    f"{coll}")
                if dist_max > 5e-7 or flips > n_res // 20:
                    raise AssertionError(f"{mode} {scheme}: a flip is not a "
                                         "knife edge")
                if own or (mode == "replicated_cdf" and flips):
                    raise AssertionError(f"{mode} {scheme}: not reproducible")
        del w, u, ref_ai, out_ai, island

        # (d) the map-axis Woodbury transition and quadratic form
        g = torch.Generator(device=device).manual_seed(19)
        A = 0.2 * torch.randn((n_wood, nl_wood, nl_wood), generator=g,
                              device=device) / math.sqrt(nl_wood / 64)
        M = A @ A.transpose(1, 2) + 3.0 * torch.eye(nl_wood, device=device)
        W = torch.linalg.inv(M)
        hldM = 0.5 * torch.linalg.slogdet(M)[1]
        wood, quad = woodbury_rank_ny_rowsharded(mesh), \
            quad_form_rowsharded(mesh)
        W_sh, h_sh = W, hldM
        reset_collective_counts()
        for i, sign in enumerate((1.0, -1.0)):
            U = (0.4 if sign > 0 else 0.08) * torch.randn(
                (n_wood, nl_wood, 3), generator=g, device=device)
            W, hldM, _ = _woodbury_rank_ny(W, hldM, U, sign, 1e-9)
            W_sh, h_sh, bad = wood(W_sh, h_sh, U, sign)
            if bool(bad.any()):
                raise AssertionError("woodbury: a retry")
        v = torch.randn((n_wood, nl_wood), generator=g, device=device)
        q = quad(v, W_sh)
        sync(device)
        q_ref = torch.einsum("pi,pij,pj->p", v, W, v)
        d_w = float((W_sh - W).abs().max())
        d_h = float(((h_sh - hldM) / hldM).abs().max())
        d_q = float(((q - q_ref) / q_ref).abs().max())
        log(f"[18d] woodbury_rank_ny_rowsharded N={n_wood} nl={nl_wood}, two "
            f"transitions, against _woodbury_rank_ny: max|d W| {d_w:.3e} "
            f"(tol 1e-5, bit-equal {torch.equal(W_sh, W)}), hldM rel "
            f"{d_h:.3e} (tol 1e-5); quad_form_rowsharded rel {d_q:.3e} (tol "
            f"1e-4); collectives {collective_counts()}")
        if not (d_w <= 1e-5 and d_h <= 1e-5 and d_q <= 1e-4):
            raise AssertionError("the map-axis functions disagree")
    finally:
        dist.destroy_process_group()


def phase_kalman_one_particle(device, zero, n=16384, nl=128, ny=3,
                              rows=(0, 1, 4097, 16383)):
    """Phase 19: ops.kalman_update_dense (one particle; psd_cholesky and
    two triangular solves) with joseph off and on, on the card, against
    row i of kalman_update_dense_batched (the closed-form ny = 3 algebra)
    at the headline shape (N=16384, n_lin=128, f32) for a few i: xl', P'
    and logw within 1e-4 of each output's scale, retried equal. No
    kernel launches."""
    from rbslam_tpu_torch.ops import (
        kalman_update_dense,
        kalman_update_dense_batched,
    )

    g = torch.Generator(device=device).manual_seed(20)
    A = torch.randn((n, nl, nl), generator=g, device=device)
    P = A @ A.transpose(1, 2) / nl + torch.eye(nl, device=device)
    del A
    C = 0.5 * torch.randn((n, ny, nl), generator=g, device=device)
    xl = torch.randn((n, nl), generator=g, device=device)
    y = torch.randn(ny, generator=g, device=device)
    R = 0.5 * torch.eye(ny, device=device)
    reset_launch_counts()
    worst = {}
    for joseph in (False, True):
        batched = kalman_update_dense_batched(C, P, xl, y, R, 1e-3, joseph)
        for i in rows:
            one = kalman_update_dense(C[i], P[i], xl[i], y, R, 1e-3, joseph)
            if bool(one[3]) != bool(batched[3][i]):
                raise AssertionError(f"row {i}: retried differs")
            for name, a, b in zip(("xl", "P", "logw"), one, batched):
                b = b[i]
                err = float((a - b).abs().max()) / max(
                    float(b.abs().max()), 1.0)
                worst[joseph, name] = max(worst.get((joseph, name), 0.0), err)
        del batched
    counts = launch_counts()
    log(f"[19] kalman_update_dense against rows {list(rows)} of "
        f"kalman_update_dense_batched, N={n} n_lin={nl} ny={ny} f32: largest "
        f"error over the scale "
        + ", ".join(f"{name} (joseph={j}) {e:.2e}"
                    for (j, name), e in worst.items())
        + f" (tol 1e-4); launches {counts}")
    if counts != zero:
        raise AssertionError(f"launch counts {counts} != {zero}")
    if max(worst.values()) > 1e-4:
        raise AssertionError("the one-particle update disagrees")


def phase_gates(device, zero, lowrank, problem8, data8, res8,
                n_particles=16384, m=125, T=192):
    """Phase 20: the headline lowrank filter (phase 4) with stratified
    resampling under an ESS gate of 0.5, and the mag3d information-form
    smoother at phase 8's cell with suffix_precompute=False (the suffix
    pair downdated a step, :194-201), one run each: the launch counts of
    phases 4 and 8 and a finite result; position RMSE beside the
    odometry's (the smoother's aligned, of its last sweep) reported."""
    problem, data = build_problem(m, T, seed=1, m_sim=512, device=device)
    gen = torch.Generator(device=device)
    truth = torch.as_tensor(data.pos, dtype=torch.float32, device=device)
    odo = torch.as_tensor(data.odometry_path[:, :3], dtype=torch.float32,
                          device=device)

    def rmse(path):
        return float(torch.sqrt(torch.mean(torch.sum((path - truth) ** 2,
                                                     dim=-1))))

    def counted(fn, expect):
        reset_launch_counts()
        gen.manual_seed(0)
        out = fn()
        sync(device)
        if launch_counts() != expect:
            raise AssertionError(f"launch counts {launch_counts()} != "
                                 f"{expect}")
        return out

    cfg = filter_config(n_particles, "bfloat16", resampling="stratified",
                        ess_threshold=0.5)
    res = counted(lambda: run_rbpf(*problem.rbpf_args(), cfg, generator=gen,
                                   device=device), lowrank)
    check_result(res, T, n_particles, problem.potential.n_lin)
    resampled = int((res.ess[:-1] <= 0.5 * n_particles).sum())
    log(f"[20] headline lowrank r=8 bf16 stratified, ESS gate 0.5: position "
        f"RMSE {rmse(res.traj_mean[:, :3]):.4f} m (odometry "
        f"{rmse(odo):.4f}); resampled at {resampled} of {T - 1} steps")
    del problem, data, res
    scfg = RBPSConfig(n_particles=100, n_sweeps=3, resampling="systematic",
                      ancestor_form="woodbury", suffix_precompute=False)
    T8 = problem8.y.shape[0]
    res = counted(lambda: run_rbps_information_form(
        *problem8.rbpf_args(), scfg, generator=gen, device=device),
        {**zero, "grad_basis": 3 * T8 + 2})
    if not bool(torch.isfinite(res.XNK).all()):
        raise AssertionError("suffix_precompute=False: XNK has non-finite "
                             "values")
    r = float(aligned_position_rmse(data8.pos, res.XNK[-1, :, :3]))
    r_odo = float(aligned_position_rmse(data8.pos,
                                        data8.odometry_path[:, :3]))
    d = float((res.XNK - res8.XNK).abs().max())
    log(f"[20] mag3d info-form smoother, suffix_precompute=False, N_P=100 "
        f"T={T8} 3 sweeps: aligned position RMSE of the last sweep {r:.4f} m "
        f"(odometry {r_odo:.4f}); max|d XNK| from phase 8's "
        f"precomputed-suffix run {d:.3e}")


def missing_keys(got, ref, where=""):
    """The keys of ``ref``, at every depth, that ``got`` lacks."""
    if not isinstance(ref, dict):
        return []
    if not isinstance(got, dict):
        return [where or "<top>"]
    out = []
    for k, v in ref.items():
        if k not in got:
            out.append(f"{where}/{k}")
        else:
            out += missing_keys(got[k], v, f"{where}/{k}")
    return out


def phase_reproduce(device, zero, n_mc=3, mc_sweeps=5, n_sim=2,
                    box_sweeps=2, disturbances=(0.0, 10.0)):
    """Phase 21: the reproduction scripts at full width, small depth. K6
    launches of run_mc: per run T (filter) + sweeps T + sweeps - 1
    (smoother); per boxplot run, the lowrank filter K4 = 1, K1 = K2 = 191,
    K3 = 24 (phase 4's), the xla filter K4 = 192, and the smoother
    K4 = sweeps T + sweeps - 1. compare.py's verdicts are printed as
    REPORTED: at 2-3 runs a side they say nothing."""
    check_tf32_off()
    ref = verdicts.load_dir("results", verdicts.BOXPLOTS + verdicts.RADIO
                            + ("line_figures_summary",))
    port = {}
    mc = run_mc.config("line_3D", n_mc=n_mc, n_sweeps=mc_sweeps)
    T = mc.n_steps
    runs = n_sim * len(disturbances)
    smoother = box_sweeps * 192 + box_sweeps - 1
    cases = [
        ("dense_radio_line_mc100",
         lambda: run_mc.run(mc, "jax", device=device),
         {**zero, "phi_basis": n_mc * (T + mc_sweeps * T + mc_sweeps - 1)}),
        ("dense_mag_boxplot_lowrank",
         lambda: run_boxplot_lowrank.run(
             dataclasses.replace(run_boxplot_lowrank.CONFIG,
                                 n_sweeps=box_sweeps),
             disturbances, n_sim, device=device),
         {**zero, "jac3d_rows": runs * 191, "gather_cp": runs * 191,
          "rebase": runs * 24, "grad_basis": runs * (1 + smoother)}),
        ("dense_mag_boxplot",
         lambda: run_boxplot.run(
             dataclasses.replace(run_boxplot.CONFIG, n_sweeps=box_sweeps),
             disturbances, n_sim, device=device),
         {**zero, "grad_basis": runs * (192 + smoother)}),
    ]
    for stem, fn, expect in cases:
        reset_launch_counts()
        out = json.loads(json.dumps(fn()))
        sync(device)
        counts = launch_counts()
        log(f"[21] {stem}: launches {counts}")
        if counts != expect:
            raise AssertionError(f"launch counts {counts} != {expect}")
        ref_keys = ref[stem]
        if "raw" in ref_keys:
            ref_keys = {**ref_keys,
                        "raw": {o: ref_keys["raw"][o] for o in out["raw"]},
                        "rmse_by_disturbance": {
                            o: ref_keys["rmse_by_disturbance"][o]
                            for o in out["raw"]}}
        missing = missing_keys(out, ref_keys)
        if missing:
            raise AssertionError(f"{stem}: keys of the JAX results file "
                                 f"missing: {missing}")
        if "raw" in out:
            values = [v for r in out["raw"].values() for vs in r.values()
                      for v in vs]
            log(f"[21] {stem}: NaN runs {out['nan_runs']}; raw "
                f"{json.dumps(out['raw'])}")
        else:
            values = [v for row in out["rmse_filter_all"] for v in row] \
                + out["rmse_smoother_per_sweep"] \
                + out["rmse_smoother_final_all"]
            log(f"[21] {stem}: filter max/mean {out['rmse_filter_max_mean']}"
                f", smoother final per run {out['rmse_smoother_final_all']}")
        if not all(math.isfinite(v) for v in values):
            raise AssertionError(f"{stem}: non-finite RMSE")
        port[stem] = out
    v = verdicts.verdicts(port, ref)
    log(f"[21] compare.py at {n_mc} radio runs and {n_sim} seeds a "
        f"disturbance ({v['family']} Mann-Whitney tests, Holm at "
        f"{v['alpha']}), reported:")
    verdicts.print_verdicts(v, prefix="[21] ", status="REPORTED")


def phase_bench(device, card, zero, lowrank, n_big=131072, T=192):
    """Phase 22: the benchmark entry point (rbslam_tpu_torch/bench.py).
    ``bench.main(["--quick"])`` on the card: the card's stamp, then the
    terrain PF row and the headline row, each with bench.py's four keys and
    finite positive values, and the quick filter's launches (a warm-up and
    3 repeats at T=64: K4 1, K1 and K2 63, K3 8 a run). Then one run of
    bench.py's 131,072-particle filter at full width (m=125, n_lin 128,
    T=192, bf16, lowrank r=8, store_trajectories=False) through
    ``bench.rbpf_case``: phase 4's launches, finite logw, traj_mean and
    P_mean, no history, position RMSE under the odometry's."""
    reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench.main(["--quick"])
    counts = launch_counts()
    lines = out.getvalue().strip().splitlines()
    if not lines[0].startswith(f"card: {card}"):
        raise AssertionError(f"bench's first line is not the card's stamp: "
                             f"{lines[0]!r}")
    rows = [json.loads(line) for line in lines[1:]]
    names = [r["metric"].split("[")[0] for r in rows]
    if names != ["terrain_pf_particle_steps_per_s",
                 "rbpf_dense_mag_particle_steps_per_s"]:
        raise AssertionError(f"bench --quick rows {names}")
    for r in rows:
        if set(r) != {"metric", "value", "unit", "vs_baseline"} or not (
                math.isfinite(r["value"]) and r["value"] > 0):
            raise AssertionError(f"bench row {r}")
    if not (math.isfinite(rows[-1]["vs_baseline"])
            and rows[-1]["vs_baseline"] > 0):
        raise AssertionError(f"headline vs_baseline {rows[-1]}")
    quick = {**zero, "grad_basis": 4, "jac3d_rows": 4 * 63,
             "gather_cp": 4 * 63, "rebase": 4 * 8}
    log(f"[22] bench --quick: the card's stamp, rows {names} with the four "
        f"keys and finite positive values; launches {counts}")
    if counts != quick:
        raise AssertionError(f"launch counts {counts} != {quick}")

    run, problem, data = bench.rbpf_case(
        125, n_big, T, device=device, cov_dtype="bfloat16",
        kf_kernel="lowrank", store_trajectories=False)
    reset_launch_counts()
    res = run(1)
    counts = launch_counts()
    if counts != lowrank:
        raise AssertionError(f"launch counts {counts} != {lowrank}")
    for field, shape in (("traj_mean", (T, 7)), ("traj_max", (T, 7)),
                         ("logw", (n_big,)), ("P_mean", (128, 128)),
                         ("ancestors", (T - 1, n_big))):
        t = getattr(res, field)
        if tuple(t.shape) != shape:
            raise AssertionError(f"{field} shape {tuple(t.shape)} != {shape}")
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{field} has non-finite values")
    if res.xn_hist.numel() or res.xn_traj.numel():
        raise AssertionError("store_trajectories=False kept a history")
    truth = torch.as_tensor(data.pos, dtype=torch.float32, device=device)
    odo = torch.as_tensor(data.odometry_path[:, :3], dtype=torch.float32,
                          device=device)
    rmse = float(torch.sqrt(torch.mean(
        torch.sum((res.traj_mean[:, :3] - truth) ** 2, dim=-1))))
    rmse_odo = float(torch.sqrt(torch.mean(torch.sum((odo - truth) ** 2,
                                                     dim=-1))))
    log(f"[22] bench.rbpf_case N_P={n_big} m=125 (n_lin 128) T={T} bf16 "
        f"lowrank r=8 no-traj: launches {counts}; position RMSE of traj_mean "
        f"{rmse:.4f} m (odometry {rmse_odo:.4f} m); chol_retries "
        f"{int(res.chol_retries)}")
    if not rmse < rmse_odo:
        raise AssertionError(f"RMSE {rmse} not under the odometry's "
                             f"{rmse_odo}")
    del res, run, problem


def predictive_case(device, n, m, seed=23):
    """A map posterior of m basis functions, fitted (theta (10, 1, 25, 4)
    of the benchmark's localization cell, no ML-II) to seeded readings on
    the mapping path of workloads/mag_localization.py (11 lines of 40),
    and K4's basis gradients g [n, 3, m] at n centred positions drawn
    over the mapped area: (g, L, w, sigma2)."""
    gen = torch.Generator().manual_seed(seed)
    x_map = mag_localization._lawnmower(4.0, 11)
    y_map = torch.randn((len(x_map), 3), generator=gen,
                        dtype=torch.float64).numpy() * 5.0
    lo, hi = x_map.min(0), x_map.max(0)
    LL = np.stack([lo - 0.2 * 8.0, hi + 0.2 * 8.0])
    gp = fit_scalar_potential_gp(x_map, y_map, m, LL, (10.0, 1.0, 25.0, 4.0),
                                 optimize=False, device=device)
    u = torch.rand((n, 2), generator=gen, dtype=torch.float64)
    x = np.zeros((n, 3), np.float32)
    x[:, :2] = (lo[:2] + (hi[:2] - lo[:2]) * u.numpy()) - gp.center[:2]
    x[:, 2] = -gp.center[2]
    consts = pack_basis_constants(gp.potential.basis, device)
    g = grad_basis(consts, torch.as_tensor(x, device=device))
    return g, gp.chol, gp.mean_weights, float(gp.theta[3])


def phase_predictive(device):
    """Phase 23, K12 gp_predictive: against its plain version at the
    exact localization cell's shape (65,536 positions, m = 1000: 196,608
    rows of width 1003), at 512 positions and at a ragged width (m = 997,
    n_lin 1000, 3003 rows) within ``compare``'s float32 tolerance; at the
    cell's shape also against a float64 solve of the same float32 L and
    rows (variance 1e-5 relative, mean 1e-5 of its largest magnitude,
    beside the float32 solve's own errors); two launches bit-equal in each
    case. Returns the kernels line's row (the cell's shape)."""
    check_tf32_off()
    row = None
    for n, m in ((65536, 1000), (512, 1000), (1001, 997)):
        g, L, w, sigma2 = predictive_case(device, n, m)
        pc = pack_predictive(L, w, sigma2)
        n_lin, rows = m + 3, 3 * n
        note = f"N={n} rows={rows} n_lin={n_lin} float32"
        r = compare("predictive", lambda: gp_predictive(pc, g),
                    lambda: gp_predictive_plain(pc, g), device,
                    torch.float32, note, (g, pc.table))
        a, b = gp_predictive(pc, g), gp_predictive(pc, g)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"[23] predictive {note}: two launches "
                                 "differ")
        log(f"[23] predictive {note}: two launches bit-equal")
        if row is not None:
            continue
        C = torch.cat([torch.eye(3, device=device).expand(n, 3, 3), g],
                      dim=-1).reshape(rows, n_lin)
        Lt = L.to(torch.float32)
        V = torch.linalg.solve_triangular(Lt.double(), C.double().T,
                                          upper=False)
        var64 = sigma2 * torch.sum(V * V, dim=0)
        mean64 = C.double() @ w.double()
        del V
        V32 = torch.linalg.solve_triangular(Lt, C.T, upper=False)
        var32 = sigma2 * torch.sum(V32 * V32, dim=0)
        del V32, C
        mean_k, var_k = (t.reshape(-1).double() for t in a)
        mean_p, var_p = (t.reshape(-1).double()
                         for t in gp_predictive_plain(pc, g))
        scale = float(mean64.abs().max())

        def errs(mean, var):
            return (float(((var - var64) / var64).abs().max()),
                    float((mean - mean64).abs().max()) / scale)

        ek, ep, es = errs(mean_k, var_k), errs(mean_p, var_p), \
            errs(mean64, var32.double())
        log(f"[23] predictive {note} against a float64 solve: var rel err "
            f"kernel {ek[0]:.3e}, plain {ep[0]:.3e}, float32 solve "
            f"{es[0]:.3e} (tol 1e-5); mean err over max |mean| "
            f"({scale:.3e}) kernel {ek[1]:.3e}, plain {ep[1]:.3e} (tol "
            f"1e-5); var range {float(var64.min()):.4f}-"
            f"{float(var64.max()):.4f}")
        if not (ek[0] <= 1e-5 and ek[1] <= 1e-5):
            raise AssertionError("K12 outside its float32 tolerance of the "
                                 "float64 solve")
        row = r
    return row


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "needs one NVIDIA GPU")
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    _lib.lib()
    log(f"[2] kernels built and loaded ("
        + ("a cached build" if _lib.build_seconds is None else "nvcc") + ")")

    rows, counts_3 = phase_compare(device)
    zero = dict.fromkeys(_lib.KERNEL_NAMES, 0)
    # lowrank, T=192: step 0 (K4) + 191 steps (K1, K2) in 23 periods of 8
    # and a remainder period of 7, each closed by one rebase (K3)
    lowrank = {**zero, "grad_basis": 1, "jac3d_rows": 191,
               "gather_cp": 191, "rebase": 24}
    counts = run_path("4", device, 125, 192, filter_config(16384, "bfloat16"),
                      lowrank)
    run_path("5", device, 509, 192, filter_config(4096, "float32"), lowrank)
    # block_gather: K4 at every step's Jacobian (step 0 included), K5 at
    # every step after step 0; xla: K4 only
    block = {**zero, "grad_basis": 192, "block_gather": 191}
    counts_block = run_path(
        "4b", device, 125, 192,
        filter_config(16384, "bfloat16", "block_gather"), block)
    run_path("5b", device, 509, 192,
             filter_config(4096, "float32", "block_gather"), block)
    run_path("4c", device, 125, 192,
             filter_config(16384, "bfloat16", "xla", "multinomial"),
             {**zero, "grad_basis": 192})
    counts["block_gather"] = counts_block["block_gather"]
    phase_plain_vs_kernel(device)
    phase_smoothers_plain_vs_kernel(device)
    phase_ekf_plain_vs_card(device)
    phase_pf_plain_vs_card(device)
    phase_sparse_plain_vs_card(device)
    counts["phi_basis"] = phase_radio(device, zero)["phi_basis"]
    counts_s, problem, data, res = phase_mag_smoother(device, zero)
    log(f"[8] grad_basis launches on the filter's lowrank path "
        f"{counts['grad_basis']}, on the smoother's path "
        f"{counts_s['grad_basis']}")
    counts["grad_basis"] = counts_s["grad_basis"]
    counts["jac3d"] = phase_jac3d_entry(device, zero, problem, data,
                                        res)["jac3d"]
    phase_resume_info(device, zero, problem, res)
    problem8, data8, res8 = problem, data, res
    del problem, data, res
    phase_resume_radio(device, zero)
    # the probes K8-K11 run on no path of the port: their launches in
    # phase 3's checks
    for name in ("probe_gather_cp", "probe_rebase_parts", "probe_gather",
                 "probe_block_products"):
        counts[name] = counts_3[name]
    counts_m = phase_dense_mag(device, zero)
    log(f"[11] grad_basis launches on the dense-mag comparison "
        f"{counts_m['grad_basis']} (the kernels line keeps phase 8's)")
    phase_terrain_pf(device, zero)
    counts["predictive"] = phase_mag_localization(device, zero)["predictive"]
    phase_sparse_visual(device, zero)
    phase_profiling(device, lowrank)
    phase_cli(device, zero)
    phase_mesh(device, zero, problem8, res8)
    phase_kalman_one_particle(device, zero)
    phase_gates(device, zero, lowrank, problem8, data8, res8)
    phase_reproduce(device, zero)
    phase_bench(device, card, zero, lowrank)
    rows["predictive"] = phase_predictive(device)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], **rows[name]}
        for name, (src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
