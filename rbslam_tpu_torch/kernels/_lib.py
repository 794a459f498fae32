"""Build, load and count the hand-written CUDA kernels.

The sources under ``rbslam_tpu_torch/csrc/`` are compiled at first use
with ``nvcc`` for Hopper (``sm_90a``) into one shared library with a
plain C interface, which is loaded with ``ctypes``. The library's file
name carries a hash of the sources, so an edited source is rebuilt and
a stale build is never loaded. The build directory
(``rbslam_tpu_torch/_build/``) is listed in ``.gitignore``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; an entry that launches nothing returns an error.
Each wrapper returns an empty output before the C call (nothing to
launch) and otherwise passes the entry's code to :func:`check` right after
its launch: a non-zero code raises, and a launch is counted there and
nowhere else. :func:`launch_counts` / :func:`reset_launch_counts`
read and clear the counters, so a run can show which kernels its path
went through. A replay of a captured CUDA graph passes through no wrapper:
the code that replays it adds the launches its capture counted, once a
replay, with :func:`count_replay`. K2 also counts on the device the P_base matrices it reads:
:func:`k2_reads_counter` gives it a counter while ``utils.profiling.
recording()`` is on, and a null pointer otherwise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("basis_eval.cu", "kf_update.cu", "probes.cu", "predictive.cu")
HEADERS = ("kf_common.cuh", "kf_block.cuh")   # included by kf_update.cu, probes.cu
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

KERNEL_NAMES = ("grad_basis", "jac3d_rows", "gather_cp", "rebase",
                "block_gather", "phi_basis", "jac3d", "probe_gather_cp",
                "probe_rebase_parts", "probe_gather", "probe_block_products",
                "predictive")
_launches = dict.fromkeys(KERNEL_NAMES, 0)
_k2_reads_counter = None  # device -> address; set by recording()
_lib = None
build_seconds = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # (x, consts, scale, out, n, m, d, table, codes, u0, u1, u2, ustride,
    #  form, per_block, stream)
    "rbs_grad_basis": (_P, _P, _F, _P, _LL, _I, _I, _P, _P, _I, _I, _I, _I,
                       _I, _I, _P),
    # (pos, quat, consts, scale, out, n, m, nl_pad, out_bf16, table, codes,
    #  u0, u1, u2, ustride, form, per_block, stream)
    "rbs_jac3d_rows": (_P, _P, _P, _F, _P, _LL, _I, _I, _I, _P, _P, _I, _I,
                       _I, _I, _I, _I, _P),
    # (x, consts, scale, out, n, m, d, stream)
    "rbs_phi_basis": (_P, _P, _F, _P, _LL, _I, _I, _P),
    # (pos, quat, consts, scale, out, n, m, nl_pad, table, codes, u0, u1,
    #  u2, ustride, form, per_block, stream)
    "rbs_jac3d": (_P, _P, _P, _F, _P, _LL, _I, _I, _P, _P, _I, _I, _I, _I,
                  _I, _I, _P),
    # (bidx, C, Wt, P_base, CP, n, n_base, ny, rw, rows, nl, plan, direct,
    #  bf16, reads, stream)
    "rbs_gather_cp": (_P, _P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I,
                      _I, _P, _P),
    # (bidx, Wt, P_base, P_out, n, n_base, rw, nl, variant, bf16, stream)
    "rbs_rebase": (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P),
    # (ai, C, e, xl, P_all, R, P_out, xl_out, logw, bad, n, n_all, ny, nl,
    #  jitter, plan, bf16, stream)
    "rbs_block_gather": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _LL, _LL,
                         _I, _I, _F, _I, _I, _P),
    # (bidx, C, P, CP, n, n_base, ny, nl, plan, bf16, stream)
    "rbs_probe_gather_cp": (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _P),
    # (bidx, Wt, P, out, n, n_base, rw, nl, do_gather, do_dot, variant, bf16,
    #  stream)
    "rbs_probe_rebase_parts": (_P, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I,
                               _I, _P),
    # (ai, P, out, n, n_all, nl, bf16, stream)
    "rbs_probe_gather": (_P, _P, _P, _LL, _LL, _I, _I, _P),
    # (C, P, out, n, ny, nl, plan, bf16, stream)
    "rbs_probe_block_products": (_P, _P, _P, _LL, _I, _I, _I, _I, _P),
    # (g, table, sigma2, mean, var, rows, m, ldb, table_rows, stream)
    "rbs_predictive": (_P, _P, _F, _P, _P, _LL, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
        "are built from rbslam_tpu_torch/csrc at first use"
    )


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in (*SOURCES, *HEADERS):
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _run(procs) -> str:
    """Wait for every nvcc process; raise if any failed; return the output."""
    text = ""
    failed = []
    for p in procs:
        stdout, stderr = p.communicate()
        text += stdout + stderr
        if p.returncode != 0:
            failed.append(f"{' '.join(p.args)} ({p.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed: {failed}\n{text}")
    return text


def build(verbose: bool = False) -> Path:
    """Compile the kernel library if no build of these sources exists;
    return its path. Each source is compiled by its own nvcc, all started
    together, then linked into one shared library. ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory and spills per kernel) and
    prints the compiler's output."""
    global build_seconds
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"librbslam_kernels_{_source_hash()}.so"
    if out.exists() and not verbose:
        return out
    t0 = time.perf_counter()
    nvcc = _nvcc()
    flags = [*NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else [])]
    objs = [out.with_name(f"{Path(s).stem}.{os.getpid()}.o") for s in SOURCES]
    text = _run([
        subprocess.Popen([nvcc, *flags, "-c", "-o", str(o), str(CSRC / s)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for s, o in zip(SOURCES, objs)
    ])
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    text += _run([subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
    for o in objs:
        o.unlink()
    if verbose:
        print(text)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        major, minor = torch.cuda.get_device_capability()
        if (major, minor) != (9, 0):
            raise RuntimeError(
                f"kernels are built for sm_90a (Hopper); this card is "
                f"sm_{major}{minor}"
            )
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(code: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error; else count the launch."""
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {code}")
    _launches[name] += 1


def launch_counts() -> dict:
    return dict(_launches)


def count_replay(launches: dict) -> None:
    """Count one replay of a captured CUDA graph: ``launches`` are the
    counts that :func:`check` made while the graph was captured."""
    for name, n in launches.items():
        _launches[name] += n


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


def k2_reads_counter(device) -> int:
    """The address of a device int64 that K2 adds the P_base matrices it
    read to, kept by the open ``utils.profiling.recording()`` for the call
    being recorded; 0, a null pointer that tells the kernel to count
    nothing, where no recording is on."""
    source = _k2_reads_counter
    return 0 if source is None else source(device)
