"""Cells of the port's particle filter, ``rbslam_tpu_torch.engines.run_rbpf``
on a dense magnetic-SLAM problem: one operation is one call over the whole
trajectory with fresh draws (u [T-1] systematic uniforms, or [T-1, N] for
the other schemes, and w [T-1, N, 6] dynamics normals, through the
engine's ``noise`` seam).
"""

from __future__ import annotations

import importlib

import torch

from .. import roofline
from ..traffic import draws, stream_seed


class Cell:
    """One configuration under one traffic mix, built on ``device`` from the
    run's seed."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from rbslam_tpu_torch.engines import RBPFConfig

        self.device = torch.device(device)
        self.seed = seed
        problem = importlib.import_module(
            f"benchmark.problems.{config['problem']}")
        self.data, basis, self.problem = problem.build(config, seed,
                                                       self.device)
        self.n = n = int(traffic["n_particles"])
        T = int(self.data.y.shape[0])
        self.n_lin = basis.n_lin
        self.cfg = RBPFConfig(n_particles=n, **config["engine_config"])
        self.reference = importlib.import_module(
            f"benchmark.reference.{config['reference']}")
        u_shape = (T - 1,) if self.cfg.resampling == "systematic" \
            else (T - 1, n)
        self.noise_shapes = [("uniform", u_shape), ("normal", (T - 1, n, 6))]
        self.work_per_call = n * T            # particle-steps
        self.steps_per_call = T
        g_s = torch.Generator().manual_seed(stream_seed(seed, "sample"))
        self.sample = torch.randperm(n, generator=g_s)[:min(64, n)].sort()[0]

    def call(self, noise):
        from rbslam_tpu_torch.engines import run_rbpf

        return run_rbpf(*self.problem.rbpf_args(), self.cfg, generator=None,
                        device=self.device, noise=noise)

    def warm(self):
        """One call: it reaches every shape of the window's calls."""
        return self.call(draws(self.noise_shapes, self.seed, "warm", 0,
                               self.device))

    def control(self, noise, variant: str = "control") -> dict:
        """The control in the program's place: the program with TF32
        matmuls on, one precision below the configuration's float32 with
        TF32 off (its own kernels stay float32)."""
        if variant != "control":
            raise ValueError(f"no control variant {variant!r}")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            out = self.call(noise)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        kept = self.retain(out)
        del out
        return kept

    @staticmethod
    def finite(res) -> bool:
        """Whether the call's summaries are finite: the evidence, the final
        weights, the weighted map and covariance (a sum over every
        particle's) and the mean trajectory."""
        parts = (res.log_evidence, res.logw, res.xl_mean, res.P_mean,
                 res.traj_mean)
        return bool(torch.stack([torch.isfinite(p).all() for p in parts])
                    .all())

    def retain(self, res) -> dict:
        """What the correctness check reads of a call, copied to the host
        (the kept copy takes no device memory, so the window's peak is the
        program's whatever the number of calls)."""
        idx = self.sample.to(res.P.device)
        kept = {"ancestors": res.ancestors, "xn_hist": res.xn_hist,
                "ess": res.ess, "logw": res.logw,
                "log_evidence": res.log_evidence, "xl": res.xl,
                "P_sample": res.P.index_select(0, idx)}
        return {k: v.to("cpu", copy=True) for k, v in kept.items()}

    def judge(self, kept: dict, noise) -> dict:
        """The reference's largest gaps to a retained call made with
        ``noise`` (see reference/rbpf_dense.py::judge)."""
        if self.cfg.resampling != "systematic" or self.cfg.ess_threshold < 1:
            raise NotImplementedError(
                "the reference follows systematic resampling at every step")
        u, w = noise
        kept = {k: v.to(u.device) for k, v in kept.items()}
        return self.reference.judge(self.data, u, w, kept,
                                    self.sample.to(u.device))

    def launches(self, ancestors: torch.Tensor) -> dict:
        """The port kernels' launches of one lowrank call with these
        ancestors, by family, in launch order, with their least bytes and
        operations (roofline.py) at the map's true width n_lin."""
        if self.cfg.kf_kernel != "lowrank":
            return {}
        itemsize = 2 if self.cfg.cov_dtype == "bfloat16" else 4
        n, nl, ny, r = self.n, self.n_lin, 3, self.cfg.lowrank_period
        distinct = roofline.distinct_bases(ancestors, r)
        steps = len(distinct)
        k2 = [roofline.k2_gather_cp(n, distinct[t], nl, ny * (t % r),
                                    itemsize) for t in range(steps)]
        ends = [t for t in range(steps) if t % r == r - 1 or t == steps - 1]
        k3 = [roofline.k3_rebase(n, distinct[t], nl, ny * (t % r + 1),
                                 itemsize) for t in ends]
        return {
            "K4": [roofline.k4_grad_basis(n, nl - 3)],
            "K1": [roofline.k1_jacobian_rows(n, nl, itemsize)] * steps,
            "K2": k2,
            "K3": k3,
        }
