"""Run the port's mesh cases on gloo ranks of CPU processes.

This module imports torch, numpy and the port only, never JAX: the test
process (which runs JAX) writes a job file and starts ``world`` children
with ``python tests/torch_ranks.py DIR RANK WORLD``; each joins a gloo
process group on a FileStore under DIR (no TCP port, so concurrent test
workers cannot collide), builds ``make_mesh(*job["mesh"],
device_type="cpu")``, runs the named cases of :data:`CASES` on the job's
numpy inputs and saves its results to DIR/rank{RANK}.pt. Every case
returns what its test compares: whole tensors (``gather_particles``) for
per-particle fields, and a rank's own value of everything replicated.
"""

from __future__ import annotations

import os
import subprocess
import sys
import traceback
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

REPO = Path(__file__).resolve().parent.parent
CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def t(a):
    return torch.as_tensor(np.asarray(a))


class Ranks:
    """``world`` ranks running ``cases`` on a ``mesh`` shape, started at
    construction; :meth:`results` waits for them."""

    def __init__(self, directory, world, mesh, cases, inputs):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        torch.save({"mesh": tuple(mesh), "cases": list(cases),
                    "inputs": inputs}, self.dir / "job.pt")
        env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
        self.procs = []
        for rank in range(world):
            log = open(self.dir / f"rank{rank}.log", "w")
            self.procs.append((subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()),
                 str(self.dir), str(rank), str(world)],
                env=env, cwd=str(REPO), stdout=log,
                stderr=subprocess.STDOUT), log))

    def results(self, timeout=240) -> list:
        """Every rank's results in rank order; raises with the ranks' logs
        where one failed."""
        try:
            codes = [p.wait(timeout=timeout) for p, _ in self.procs]
        finally:
            for p, log in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.close()
        if any(codes):
            logs = "\n".join(
                f"--- rank {r} (exit {c}) ---\n"
                + (self.dir / f"rank{r}.log").read_text()[-3000:]
                for r, c in enumerate(codes) if c)
            raise RuntimeError(f"a rank failed:\n{logs}")
        return [torch.load(self.dir / f"rank{r}.pt", weights_only=False)
                for r in range(len(self.procs))]


# --- problems from numpy ------------------------------------------------------

def _mag_model(inp):
    from rbslam_tpu_torch.basis.potential import ScalarPotentialBasis
    from rbslam_tpu_torch.models.mag3d import make_mag3d_model
    from rbslam_tpu_torch.utils.interop import _basis_from_numpy

    potential = ScalarPotentialBasis(
        _basis_from_numpy(inp["NN"], inp["L"], inp["eig"]))
    return make_mag3d_model(potential, center=np.zeros(3, np.float32),
                            device="cpu")


def radio_problem(inp):
    from rbslam_tpu_torch.utils import radio_problem_from_numpy

    return radio_problem_from_numpy(
        inp["NN"], inp["L"], inp["eig"], inp["center"], inp["k"], inp["Q"],
        inp["R"], 1.0, inp["dx"], inp["y"], inp["init_state"], device="cpu")


def _as_dict(nt):
    return {k: v for k, v in nt._asdict().items()}


# --- cases ----------------------------------------------------------------------

def _steps(mesh, inp, draws):
    from rbslam_tpu_torch.parallel import (
        ShardedParticleState, gather_particles, shard_rbpf_state,
        sharded_step_fn)

    s = inp["step"]
    model = _mag_model(s)
    state = shard_rbpf_state(ShardedParticleState(
        t(s["xn"]), t(s["xl"]), t(s["P"]), t(s["logw"])), mesh)
    step = sharded_step_fn(model, mesh, t(s["R"]))
    mask = torch.ones(3)
    for u_res, w in s[draws]:
        state, ess = step(state, t(s["y_t"]), mask, t(s["u"]), t(s["Q"]),
                          torch.tensor(0.01), noise=(t(u_res), t(w)))
    return {**_as_dict(gather_particles(state, mesh)), "ess": ess}


@case
def step(mesh, inp):
    return _steps(mesh, inp, "draws")


@case
def chain(mesh, inp):
    return _steps(mesh, inp, "chain_draws")


@case
def resamplers(mesh, inp):
    from rbslam_tpu_torch.parallel import (
        particle_sharding, sharded_resample_indices)

    sh = particle_sharding(mesh, 1)
    w = sh.local(t(inp["resample"]["w"]))
    return {(mode, scheme): sh.gather(sharded_resample_indices(
                t(u), w, mesh, scheme, mode))
            for mode in ("replicated_cdf", "prefix")
            for scheme, u in inp["resample"]["u"].items()}


@case
def island(mesh, inp):
    from rbslam_tpu_torch.parallel import (
        particle_sharding, sharded_resample_local)

    sh = particle_sharding(mesh, 1)
    w = sh.local(t(inp["island"]["w"]))
    draws = [sharded_resample_local(t(u), w, mesh)
             for u in inp["island"]["u"]]
    return {"ai": torch.stack([sh.gather(a) for a, _ in draws]),
            "logw": torch.stack([sh.gather(lw) for _, lw in draws])}


def _rbpf(mesh, inp, name):
    from rbslam_tpu_torch.engines import RBPFConfig, run_rbpf
    from rbslam_tpu_torch.parallel import (
        collective_counts, gather_particles, reset_collective_counts)

    r = inp[name]
    args = radio_problem(inp["radio"]).rbpf_args()
    reset_collective_counts()
    res = run_rbpf(*args, RBPFConfig(**r["config"]), generator=None,
                   device="cpu", noise=(t(r["u"]), t(r["w"])), mesh=mesh)
    counts = collective_counts()
    return {"rank": _as_dict(res), "counts": counts,
            "whole": _as_dict(gather_particles(res, mesh))}


@case
def rbpf_full(mesh, inp):
    return _rbpf(mesh, inp, "rbpf_full")


@case
def rbpf_ess(mesh, inp):
    return _rbpf(mesh, inp, "rbpf_ess")


@case
def rbpf_local(mesh, inp):
    return _rbpf(mesh, inp, "rbpf_local")


@case
def rbpf_joseph(mesh, inp):
    return _rbpf(mesh, inp, "rbpf_joseph")


@case
def sparse(mesh, inp):
    """The pinhole (sparse, masked EKF) model on ``mesh``."""
    from rbslam_tpu_torch.engines import RBPFConfig, run_rbpf
    from rbslam_tpu_torch.models import PinholeCamera, make_pinhole2d_model
    from rbslam_tpu_torch.parallel import gather_particles

    r = inp["sparse"]
    model = make_pinhole2d_model(PinholeCamera(*r["camera"]), r["M"])
    res = run_rbpf(model, *(t(a) for a in r["args"]), 1.0,
                   RBPFConfig(n_particles=r["n"]), generator=None,
                   device="cpu", noise=(t(r["u"]), t(r["w"])), mesh=mesh)
    return _as_dict(gather_particles(res, mesh))


@case
def kalman_forms(mesh, inp):
    """The dense update's small (ny = 3) and lax (ny = 4) forms and the
    masked update on this rank's particles and P rows, symmetrized,
    gathered whole."""
    from rbslam_tpu_torch.ops.kalman import (
        kalman_update_dense_batched_hld, kalman_update_masked_batched)
    from rbslam_tpu_torch.parallel import (
        particle_map_sharding, particle_sharding)
    from rbslam_tpu_torch.parallel.map_axis import MapAxis

    r = inp["kalman"]
    part, mat = particle_sharding(mesh, 2), particle_map_sharding(mesh, 3, 1)
    P = mat.local(t(r["P"]))
    axis = MapAxis(mesh, P.shape[-1])
    out = {}
    for form in ("small", "lax"):
        f = r[form]
        xl, Pn, logw, bad, hld = kalman_update_dense_batched_hld(
            part.local(t(f["C"])), P, part.local(t(r["xl"])), t(f["y"]),
            t(f["R"]), 1e-3, axis=axis)
        out[form] = [part.gather(xl), mat.gather(Pn), part.gather(logw),
                     part.gather(bad), part.gather(hld)]
    m = r["masked"]
    xl, Pn, logw, bad = kalman_update_masked_batched(
        part.local(t(m["yhat"])), part.local(t(m["H"])), P,
        part.local(t(r["xl"])), t(m["y"]), t(m["R"]), t(m["mask"]), 1e-3,
        axis)
    out["masked"] = [part.gather(xl), mat.gather(Pn), part.gather(logw),
                     part.gather(bad)]
    return out


@case
def kernel_refusal(mesh, inp):
    from rbslam_tpu_torch.engines import RBPFConfig, run_rbpf

    try:
        run_rbpf(*radio_problem(inp["radio"]).rbpf_args(),
                 RBPFConfig(n_particles=16, kf_kernel="block_gather"),
                 generator=torch.Generator().manual_seed(0), device="cpu",
                 mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def _info(mesh, inp, name):
    from rbslam_tpu_torch.engines import RBPSConfig, run_rbps_information_form
    from rbslam_tpu_torch.parallel.mesh import all_gather, mesh_axes

    r = inp[name]
    res = run_rbps_information_form(
        *radio_problem(inp["radio"]).rbpf_args(), RBPSConfig(**r["config"]),
        generator=None, device="cpu", noise=tuple(t(a) for a in r["noise"]),
        mesh=mesh)
    out = _as_dict(res)
    out["ancestors"] = all_gather(res.ancestors, mesh_axes(mesh).part_group,
                                  2)
    return out


@case
def info(mesh, inp):
    return _info(mesh, inp, "info")


@case
def info_joseph(mesh, inp):
    return _info(mesh, inp, "info_joseph")


@case
def info_resume(mesh, inp):
    """The information-form smoother on ``mesh`` from a generator: 2 sweeps
    unbroken, then 1 sweep with a checkpoint directory (shared by the
    ranks) and a resume to 2 whose generator is seeded otherwise (its
    state comes from the checkpoint). Returns both results and the
    checkpoint's ancestors."""
    import numpy as np

    from rbslam_tpu_torch.engines import RBPSConfig, run_rbps_information_form
    from rbslam_tpu_torch.utils import latest_step

    args = radio_problem(inp["radio"]).rbpf_args()
    ckpt = Path(inp["run_dir"]) / "ckpt"

    def run(n_sweeps, seed, directory=None):
        return run_rbps_information_form(
            *args, RBPSConfig(16, n_sweeps, resampling="stratified"),
            generator=torch.Generator().manual_seed(seed), device="cpu",
            mesh=mesh, checkpoint_dir=directory)

    unbroken = run(2, 21)
    first = run(1, 21, str(ckpt))
    steps = [latest_step(str(ckpt))]
    resumed = run(2, 99, str(ckpt))
    steps.append(latest_step(str(ckpt)))
    with np.load(ckpt / "ckpt_2.npz") as f:
        saved = torch.from_numpy(f["['sweeps'].ancestors"])
    return {"unbroken": _as_dict(unbroken), "resumed": _as_dict(resumed),
            "first": _as_dict(first), "steps": steps, "saved": saved}


@case
def woodbury(mesh, inp):
    from rbslam_tpu_torch.parallel import (
        particle_map_sharding, particle_sharding, quad_form_rowsharded,
        woodbury_rank_ny_rowsharded)

    r = inp["woodbury"]
    wood, quad = woodbury_rank_ny_rowsharded(mesh), quad_form_rowsharded(mesh)
    mat, part = particle_map_sharding(mesh, 3, 1), particle_sharding(mesh, 1)
    W, hldM = mat.local(t(r["W"])), part.local(t(r["hldM"]))
    retried = []
    for U, sign in zip(r["U"], r["sign"]):
        W, hldM, bad = wood(W, hldM, part.local(t(U)), sign)
        retried.append(bool(bad.any()))
    q = quad(part.local(t(r["v"])), W)
    return {"W": mat.gather(W), "hldM": part.gather(hldM),
            "q": part.gather(q), "retried": retried}


@case
def hybrid(mesh, inp):
    from rbslam_tpu_torch.parallel import (
        initialize_distributed, make_hybrid_mesh)

    m = make_hybrid_mesh(n_map_shards=2, device_type="cpu")
    try:
        make_hybrid_mesh(n_map_shards=3, device_type="cpu")
        refused = None
    except ValueError as e:
        refused = str(e)
    return {"initialized": initialize_distributed(device="cpu"),
            "shape": tuple(m.mesh.shape), "names": m.mesh_dim_names,
            "refused": refused}


@case
def validation(mesh, inp):
    from rbslam_tpu_torch.parallel import make_mesh

    try:
        make_mesh(3, 2, device_type="cpu")
    except ValueError as e:
        return str(e)
    return None


@case
def info_size_mismatch(mesh, inp):
    """The information-form smoother with 15 particles on a small radio
    problem the port builds itself, on ``mesh``'s particle shards."""
    from rbslam_tpu_torch.engines import RBPSConfig, run_rbps_information_form
    from rbslam_tpu_torch.workloads import dense_radio

    prob, _ = dense_radio.build_problem(
        dense_radio.DenseRadioConfig(n_steps=6, m_basis=8, m_sim=16),
        torch.Generator().manual_seed(1), device="cpu")
    try:
        run_rbps_information_form(
            *prob.rbpf_args(), RBPSConfig(15, 2),
            generator=torch.Generator().manual_seed(0), device="cpu",
            mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def main(directory, rank, world):
    from rbslam_tpu_torch.parallel import make_mesh

    directory = Path(directory)
    torch.set_num_threads(1)
    job = torch.load(directory / "job.pt", weights_only=False)
    dist.init_process_group(
        "gloo", init_method=f"file://{directory / 'store'}", rank=rank,
        world_size=world, timeout=timedelta(seconds=120))
    try:
        mesh = make_mesh(*job["mesh"], device_type="cpu")
        inputs = dict(job["inputs"], run_dir=str(directory))
        out = {name: CASES[name](mesh, inputs) for name in job["cases"]}
        out["imported_jax"] = sorted(
            m for m in sys.modules
            if m == "jax" or m.startswith("jax.") or m == "rbslam_tpu"
            or m.startswith("rbslam_tpu."))
        torch.save(out, directory / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    try:
        main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
