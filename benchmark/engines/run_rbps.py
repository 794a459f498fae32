"""Cells of the port's conditional particle smoother with ancestor sampling
(CPF-AS), ``rbslam_tpu_torch.engines.run_rbps`` on a dense radio-SLAM
problem: one operation is one call of N_K sweeps over the whole trajectory
with fresh draws (u [N_K, T-1, N] multinomial uniforms, w [N_K, T-1, N, 1]
heading normals, u_anc [N_K, T-1] ancestor-sampling uniforms, u_pick
[N_K], through the engine's ``noise`` seam). The set-up, the warm call and
what a call retains are the information-form smoother's cell's
(run_rbps_information_form.py)."""

from __future__ import annotations

import torch

from . import run_rbps_information_form


class Cell(run_rbps_information_form.Cell):
    """One configuration under one traffic mix, built on ``device`` from the
    run's seed."""

    @staticmethod
    def _shapes(n_k, T, n):
        return [("uniform", (n_k, T - 1, n)), ("normal", (n_k, T - 1, n, 1)),
                ("uniform", (n_k, T - 1)), ("uniform", (n_k,))]

    def call(self, noise, cfg=None):
        from rbslam_tpu_torch.engines import run_rbps

        return run_rbps(*self.problem.rbpf_args(), cfg or self.cfg,
                        generator=None, device=self.device, noise=noise)

    def judge(self, kept: dict, noise) -> dict:
        """The reference's largest gaps to a retained call made with
        ``noise`` (reference/rbps_cpfas_dense.py)."""
        kept = {k: v.to(self.device) for k, v in kept.items()}
        return self.reference.judge(self.data, noise, kept, self.cfg.jitter)

    def control(self, noise, variant: str = "control") -> dict:
        """The reference run free in the program's place. ``control``: one
        precision below the configuration's float32 with TF32 off in each
        part: TF32 matmuls on, the covariances and the ancestor weights'
        Cholesky in float32 (the card has none lower), the poses, the
        normalized weights, their CDFs and the uniforms drawn against them
        stored in float16. Two witnesses with TF32 off: ``float32``, the
        reference in the configuration's float32 throughout (covariances,
        ancestor weights, poses, weights, CDFs and uniforms), and
        ``f32_state``, the reference in float64 but its poses, weights,
        CDFs and uniforms stored in float32. ``no_future``, a planted
        fault: the reference in float64 with ancestor weights that leave
        out the likelihood of the readings still to come."""
        ref = self.reference
        f16, f32, f64 = torch.float16, torch.float32, torch.float64
        settings = {"control": (True, f32, f16, ref.future_log_lik),
                    "float32": (False, f32, f32, ref.future_log_lik),
                    "f32_state": (False, f64, f32, ref.future_log_lik),
                    "no_future": (False, f64, f64, _no_future)}
        allow, dtype, state, future = settings[variant]
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = allow
        try:
            return ref.sweeps(self.data, noise, self.cfg.n_sweeps,
                              self.cfg.jitter, cov_dtype=dtype,
                              weights_dtype=dtype, state_dtype=state,
                              future=future)[0]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32


def _no_future(xl, P, C, y, r, jitter, dtype):
    return torch.zeros(xl.shape[0], dtype=dtype, device=xl.device)
