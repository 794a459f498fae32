"""The dense-mag disturbance boxplot on the flagship kernel path (port of
scripts/run_boxplot_lowrank.py; main.m:37-60): the filter on
``kf_kernel="lowrank"`` (the factored carry; K1 ``jac3d_rows``, K2
``gather_cp``, K3 ``rebase``, K4 ``grad_basis`` on the card) at m=509
(n_lin 512), float32; the information-form smoother (K4) with its
symmetrized float32 carry, woodbury ancestor form; seeds 1 + i, as in
``run_boxplot``, whose options and ``--merge`` this shares.

    python -m rbslam_tpu_torch.reproduce.run_boxplot_lowrank \\
        [--disturbances 0 10] [--runs 20] [--out PATH]
"""

from __future__ import annotations

from dataclasses import replace

from . import run_boxplot

CONFIG = replace(
    run_boxplot.CONFIG, m_basis=509, smoother="info_form",
    kf_kernel="lowrank", cov_dtype="float32", symmetrize_cov=True, seed=1,
)


def run(cfg=CONFIG, disturbances=run_boxplot.DISTURBANCES,
        n_sim: int = run_boxplot.N_SIM, *, device="cuda",
        bf16_matmul_inputs: bool = False) -> dict:
    return run_boxplot.run(cfg, disturbances, n_sim, device=device,
                           bf16_matmul_inputs=bf16_matmul_inputs,
                           kf_kernel=cfg.kf_kernel)


def main(argv=None) -> None:
    run_boxplot.main(argv, CONFIG, __doc__, kf_kernel=CONFIG.kf_kernel)


if __name__ == "__main__":
    main()
