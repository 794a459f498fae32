"""Cells of the port's information-form smoother,
``rbslam_tpu_torch.engines.run_rbps_information_form`` on a dense
magnetic-SLAM problem: one operation is one call of N_K sweeps over the
whole trajectory with fresh draws (u [N_K, T-1, N] multinomial uniforms,
w [N_K, T-1, N, 6] dynamics normals, u_anc [N_K, T-1] ancestor-sampling
uniforms, u_pick [N_K], through the engine's ``noise`` seam)."""

from __future__ import annotations

import importlib

import torch

from ..traffic import draws


class Cell:
    """One configuration under one traffic mix, built on ``device`` from the
    run's seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from rbslam_tpu_torch.engines import RBPSConfig

        self.device = torch.device(device)
        self.seed = seed
        problem = importlib.import_module(
            f"benchmark.problems.{config['problem']}")
        self.data, _, self.problem = problem.build(config, seed,
                                                   self.device)
        n, n_k = int(traffic["n_particles"]), int(traffic["n_sweeps"])
        T = int(self.data.y.shape[0])
        self.cfg = RBPSConfig(n_particles=n, n_sweeps=n_k,
                              **config["engine_config"])
        if self.cfg.resampling != "multinomial":
            raise ValueError("the reference resamples multinomially")
        self.reference = importlib.import_module(
            f"benchmark.reference.{config['reference']}")
        self.noise_shapes = self._shapes(n_k, T, n)
        self.work_per_call = n * T * n_k      # particle-steps
        self.steps_per_call = T * n_k

    @staticmethod
    def _shapes(n_k, T, n):
        return [("uniform", (n_k, T - 1, n)), ("normal", (n_k, T - 1, n, 6)),
                ("uniform", (n_k, T - 1)), ("uniform", (n_k,))]

    def call(self, noise, cfg=None):
        from rbslam_tpu_torch.engines import run_rbps_information_form

        return run_rbps_information_form(
            *self.problem.rbpf_args(), cfg or self.cfg, generator=None,
            device=self.device, noise=noise)

    def warm(self):
        """Two sweeps: the first and a conditioned one reach every shape of
        the call."""
        n_k, T = 2, self.data.y.shape[0]
        noise = draws(self._shapes(n_k, T, self.cfg.n_particles), self.seed,
                      "warm", 0, self.device)
        return self.call(noise, self.cfg._replace(n_sweeps=n_k))

    @staticmethod
    def finite(res) -> bool:
        parts = (res.XNK, res.XLK, res.PK, res.ess)
        return bool(torch.stack([torch.isfinite(p).all() for p in parts])
                    .all())

    @staticmethod
    def retain(res) -> dict:
        """What the correctness check reads of a call, copied to the host
        (no device memory, so the window's peak is the program's)."""
        kept = {"XNK": res.XNK, "XLK": res.XLK, "PK": res.PK, "ess": res.ess,
                "ancestors": res.ancestors, "kept": res.kept}
        return {k: v.to("cpu", copy=True) for k, v in kept.items()}

    def judge(self, kept: dict, noise) -> dict:
        """The reference's largest gaps to a retained call made with
        ``noise`` (reference/rbps_info_dense.py)."""
        kept = {k: v.to(self.device) for k, v in kept.items()}
        return self.reference.judge(self.data, noise, kept)

    def control(self, noise, variant: str = "control") -> dict:
        """The reference run free in the program's place. ``control``: the
        engine refuses TF32, so its control is the reference with TF32
        matmuls and its ancestor weights in float32 under them, one
        precision below the configuration's float32. Two readings the
        limits were set beside: ``f32_weights``, the reference as judged
        but with float32 ancestor weights (TF32 off), a witness of what
        float32 does to the ancestor draw; ``no_future``, a planted
        fault, ancestor weights without the likelihood of the measurements
        still to come."""
        ref = self.reference
        tf32 = torch.backends.cuda.matmul.allow_tf32
        settings = {"control": (True, torch.float32, ref._future_log_lik),
                    "f32_weights": (False, torch.float32,
                                    ref._future_log_lik),
                    "no_future": (False, torch.float64, _no_future)}
        allow, dtype, future = settings[variant]
        torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            return ref.sweeps(self.data, noise, self.cfg.n_sweeps,
                              weights_dtype=dtype, future=future)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32

    def launches(self, ancestors) -> dict:
        return {}          # no roofline plan for this engine


def _no_future(xl, P, A, b, dtype):
    return torch.zeros(xl.shape[0], dtype=dtype, device=xl.device)
