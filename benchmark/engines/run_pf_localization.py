"""Cells of the port's plain particle filter on a fixed magnetic map,
``rbslam_tpu_torch.engines.run_pf_localization`` with the exact terrain
model (``models/terrain.py::make_terrain_model``): the map is fitted once
at set-up (``gp.fit_scalar_potential_gp``, the hyperparameters given);
one operation is one call over the whole test loop with fresh draws (u
[T-1, N] multinomial uniforms and w [T-1, N, 6] dynamics normals through
the engine's ``noise`` seam, and [N, 2] uniforms that spread the initial
cloud over the mapped area).
"""

from __future__ import annotations

import importlib

import torch

from .. import roofline
from ..traffic import draws


class _Bf16SolveInputs(torch.overrides.TorchFunctionMode):
    """Rounds the right-hand sides of every triangular solve to bfloat16
    (and back to float32): the field rows C that the exact model's
    predictive variance solves with, in a precision below the
    configuration's."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.linalg.solve_triangular:
            A, B = args[:2]
            args = (A, B.to(torch.bfloat16).to(B.dtype)) + tuple(args[2:])
        return func(*args, **kwargs)


class Cell:
    """One configuration under one traffic mix, built on ``device`` from the
    run's seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from rbslam_tpu_torch.engines import PFConfig
        from rbslam_tpu_torch.gp import fit_scalar_potential_gp
        from rbslam_tpu_torch.models import make_terrain_model

        self.device = torch.device(device)
        self.seed = seed
        self.problem = importlib.import_module(
            f"benchmark.problems.{config['problem']}")
        self.data = data = self.problem.build(config, seed, self.device)
        self.n = n = int(traffic["n_particles"])
        T = int(data.y.shape[0])
        gp = fit_scalar_potential_gp(
            data.x_map.cpu().numpy(), data.y_map.cpu().numpy(), data.m,
            data.LL, data.theta, optimize=False, device=self.device)
        self.potential = gp.potential
        self.model = make_terrain_model(
            gp.potential, gp.mean_weights, gp.chol, float(data.theta[3]),
            mode=data.mode, center=gp.center)
        self.cfg = PFConfig(n_particles=n, **config["engine_config"])
        if self.cfg.resampling != "multinomial" or \
                self.cfg.ess_threshold < 1:
            raise ValueError("the reference follows multinomial resampling "
                             "at every step")
        self.reference = importlib.import_module(
            f"benchmark.reference.{config['reference']}")
        self.noise_shapes = [("uniform", (T - 1, n)),
                             ("normal", (T - 1, n, 6)),
                             ("uniform", (n, 2))]
        self.work_per_call = n * T            # particle-steps
        self.steps_per_call = T

    def call(self, noise):
        from rbslam_tpu_torch.engines import run_pf_localization

        u, w, u0 = noise
        d = self.data
        return run_pf_localization(
            self.model.dynamics, self.model.log_weight, d.dx, d.y,
            self.problem.initial_cloud(d, u0), d.Q, d.dt, self.cfg,
            n_noise=self.model.n_noise, generator=None, device=self.device,
            noise=(u, w))

    def warm(self):
        """One call: it reaches every shape of the window's calls."""
        return self.call(draws(self.noise_shapes, self.seed, "warm", 0,
                               self.device))

    def control(self, noise, variant: str = "control") -> dict:
        """The control in the program's place, one precision below the
        configuration's float32 with TF32 off: ``control``, the program
        with TF32 matmuls on; ``bf16_solve``, the program with the field
        rows rounded to bfloat16 before the predictive variance's
        triangular solve."""
        if variant == "control":
            tf32 = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                out = self.call(noise)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = tf32
        elif variant == "bf16_solve":
            with _Bf16SolveInputs():
                out = self.call(noise)
        else:
            raise ValueError(f"no control variant {variant!r}")
        kept = self.retain(out)
        del out
        return kept

    @staticmethod
    def finite(res) -> bool:
        """Whether the call's summaries are finite: the evidence, the final
        weights and poses, the mean trajectory and the ESS."""
        parts = (res.log_evidence, res.logw, res.xn, res.traj_mean, res.ess)
        return bool(torch.stack([torch.isfinite(p).all() for p in parts])
                    .all())

    @staticmethod
    def retain(res) -> dict:
        """What the correctness check reads of a call, copied to the host
        (no device memory, so the window's peak is the program's)."""
        kept = {"ancestors": res.ancestors, "ess": res.ess, "logw": res.logw,
                "log_evidence": res.log_evidence,
                "traj_mean": res.traj_mean, "xn": res.xn}
        return {k: v.to("cpu", copy=True) for k, v in kept.items()}

    def judge(self, kept: dict, noise) -> dict:
        """The reference's largest gaps to a retained call made with
        ``noise`` (reference/pf_localization_exact.py::judge), from the
        same initial cloud."""
        u, w, u0 = noise
        kept = {k: v.to(u.device) for k, v in kept.items()}
        x0 = self.problem.initial_cloud(self.data, u0)
        return self.reference.judge(self.data, x0, u, w, kept)

    def launches(self, ancestors: torch.Tensor) -> dict:
        """The port kernels' launches of one call on the card, with their
        least bytes and operations (roofline.py): K4 once a weight
        evaluation, for the field rows of every particle."""
        if self.device.type != "cuda":
            return {}
        steps = ancestors.shape[0] + 1
        return {"K4": [roofline.k4_grad_basis(self.n, self.data.m)] * steps}
