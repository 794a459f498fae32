"""The port's public surface against the JAX package's, module by module.

For every module of ``rbslam_tpu`` the port has the module of the same name
under ``rbslam_tpu_torch``, and in it each public function and class of the
JAX module (its ``__all__``, or else the functions and classes it defines
whose names do not start with an underscore) with each of its parameters,
``key`` aside: the port's random draws come from a ``torch.Generator`` or
injected noise. A missing name or parameter fails unless :data:`ALLOWED`
lists it, keyed by the module that defines it in the JAX package; and every
entry of :data:`ALLOWED` must still be a departure, so the list stays
exactly the deliberate ones.
"""

import importlib
import inspect
from pathlib import Path

import pytest

pytest.importorskip("torch")

import rbslam_tpu  # noqa: E402,F401
import rbslam_tpu_torch  # noqa: E402,F401

# (defining JAX module, name) or (defining JAX module, name, parameter),
# or (module, None) for a module the port does not have: each a reason
ALLOWED = {
    ("rbslam_tpu.utils.cache", None):
        "XLA's compilation cache; the kernels' build cache of "
        "rbslam_tpu_torch/kernels/_lib.py does its job",
    ("rbslam_tpu.utils.cache", "enable_compilation_cache"):
        "re-exported by rbslam_tpu.utils from the module above",
    ("rbslam_tpu.utils.profiling", "ThroughputMeter"):
        "read by no path of the port; the benchmark's host clock times "
        "engine calls (benchmark/run.py)",
    ("rbslam_tpu.kernels.basis_eval", "grad_basis_pallas"):
        "the Pallas entry; the CUDA wrapper is grad_basis",
    ("rbslam_tpu.kernels.basis_eval", "phi_basis_pallas"):
        "the Pallas entry; the CUDA wrapper is phi_basis",
    ("rbslam_tpu.kernels.basis_eval", "mag3d_jacobian_pallas"):
        "the Pallas entry; the CUDA wrapper is mag3d_jacobian",
    ("rbslam_tpu.kernels.basis_eval", "mag3d_jacobian_rows_pallas"):
        "the Pallas entry; the CUDA wrapper is mag3d_jacobian_rows",
    ("rbslam_tpu.kernels.kf_update", "kf_update_lowrank", "block"):
        "a Pallas tile size; each CUDA kernel plans its own blocks",
    ("rbslam_tpu.kernels.kf_update", "kf_update_block_gather", "block"):
        "a Pallas tile size; each CUDA kernel plans its own blocks",
    ("rbslam_tpu.kernels.kf_update", "kf_rebase", "block"):
        "a Pallas tile size; each CUDA kernel plans its own blocks",
    ("rbslam_tpu.models.mag3d", "make_mag3d_model", "use_pallas_basis"):
        "the device chooses: a CUDA tensor launches the kernel",
    ("rbslam_tpu.models.radio2d", "make_radio2d_model", "use_pallas_basis"):
        "the device chooses: a CUDA tensor launches the kernel",
    ("rbslam_tpu.workloads.dense_mag", "DenseMagConfig", "pallas_basis"):
        "the device chooses (rbslam_tpu_torch/workloads/dense_mag.py)",
    ("rbslam_tpu.workloads.dense_mag", "build_problem", "cfg"):
        "JAX's build_problem(cfg, key) is the port's build_from_config; the "
        "port's build_problem takes the bench's sizes",
    ("rbslam_tpu.workloads.dense_radio", "DenseRadioConfig", "dtype"):
        "declared and never read by the JAX workload",
    ("rbslam_tpu.parallel.distributed", "initialize_distributed",
     "coordinator_address"):
        "torchrun's environment (MASTER_ADDR) gives the rendezvous",
    ("rbslam_tpu.parallel.distributed", "initialize_distributed",
     "num_processes"):
        "torchrun's environment (WORLD_SIZE) gives the world size",
    ("rbslam_tpu.parallel.distributed", "initialize_distributed",
     "process_id"):
        "torchrun's environment (RANK) gives the rank",
    ("rbslam_tpu.parallel.mesh", "make_mesh", "devices"):
        "one process a card: the mesh spans the process group's ranks",
}

ROOT = Path(__file__).resolve().parent.parent
MODULES = sorted(
    ".".join(p.relative_to(ROOT).with_suffix("").parts).replace(
        ".__init__", "")
    for p in (ROOT / "rbslam_tpu").rglob("*.py"))


def _public(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and (inspect.isfunction(v) or inspect.isclass(v))
                 and v.__module__ == mod.__name__]
    return sorted(names)


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return []


def departures(name):
    """The JAX module ``name``'s public names and parameters that the
    port's module lacks, as ALLOWED keys."""
    jmod = importlib.import_module(name)
    try:
        tmod = importlib.import_module("rbslam_tpu_torch" + name[10:])
    except ModuleNotFoundError:
        return {(name, None)}
    out = set()
    for n in _public(jmod):
        jobj = getattr(jmod, n)
        home = getattr(jobj, "__module__", name)
        if not hasattr(tmod, n):
            out.add((home, n))
            continue
        if not (inspect.isfunction(jobj) or inspect.isclass(jobj)):
            continue
        have = set(_params(getattr(tmod, n)))
        out |= {(home, n, p) for p in _params(jobj)
                if p != "key" and p not in have}
    return out


@pytest.mark.parametrize("name", MODULES)
def test_module_has_the_reference_surface(name):
    extra = {d for d in departures(name) if d not in ALLOWED}
    assert not extra, f"the port lacks {sorted(extra, key=str)}"


def test_allowed_departures_are_exact():
    """Every allowed departure is still one: nothing in ALLOWED that the
    port has since gained."""
    found = set().union(*(departures(name) for name in MODULES))
    assert set(ALLOWED) <= found, sorted(set(ALLOWED) - found, key=str)
    assert len(MODULES) > 50 and "rbslam_tpu.ops.kalman" in MODULES
