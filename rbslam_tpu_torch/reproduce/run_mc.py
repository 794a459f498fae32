"""The dense-radio Monte Carlo reproduction (port of scripts/run_mc.py;
examples/slam-dense-radio/main.m:24-27): nMC=100 runs, N_P=100, N_K=50
CPF-AS sweeps, m=128, m_sim=2000, multinomial resampling, on the line_3D
(N_T=32) or the square_3D degeneracy (N_T=48) trajectory, through
``workloads.dense_radio.run`` (K6 ``phi_basis`` on the card).

The runs share one field. ``--field jax`` (the default) takes the field the
JAX package's recorded runs used (its seed-1 draw, vendored in
``data/assets/dense_radio_jax_field.npz``), so that the port's runs and the
JAX package's differ only in the per-run noise; ``--field own`` draws the
port's own field from its seed. Beside the JAX package's keys the result
keeps each run's final-sweep smoother RMSE (``rmse_smoother_final_all``).
``--arrays PATH`` also writes what ``make_line_figures`` draws (each run's
paths and the first run's maps) to an .npz.

    python -m rbslam_tpu_torch.reproduce.run_mc --traj line_3D --out PATH
"""

from __future__ import annotations

import argparse
import os
import time
from contextlib import nullcontext

import numpy as np

from ..workloads import dense_radio
from .common import Bf16MatmulInputs, emit, setup, stamp

N_STEPS = {"line_3D": 32, "square_3D": 48}
FIELD_ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data",
    "assets", "dense_radio_jax_field.npz")


def config(traj_type: str, n_mc: int = 100,
           n_sweeps: int = 50) -> dense_radio.DenseRadioConfig:
    return dense_radio.DenseRadioConfig(
        traj_type=traj_type, n_steps=N_STEPS[traj_type], n_particles=100,
        n_sweeps=n_sweeps, n_mc=n_mc, m_basis=128)


def jax_field(traj_type: str) -> np.ndarray:
    """The JAX package's seed-1 field weights [m_sim=2000] of the
    trajectory's reference run (float32)."""
    with np.load(FIELD_ASSET) as f:
        return f[traj_type]


def run(cfg: dense_radio.DenseRadioConfig, field: str = "jax", *,
        device="cuda", on_run=None, bf16_matmul_inputs: bool = False) -> dict:
    """``dense_radio.run`` on the JAX package's field (``field="jax"``) or
    on the port's own draw (``"own"``), with ``field``, ``n_sweeps``,
    ``matmul_inputs``, ``wall_s`` and the card's stamp;
    ``bf16_matmul_inputs`` as in ``run_boxplot.run``."""
    device = setup(device)
    weights = None
    if field == "jax":
        weights = jax_field(cfg.traj_type)
        if weights.shape != (cfg.m_sim,):
            raise ValueError(f"the JAX field has {weights.shape[0]} weights; "
                             f"m_sim is {cfg.m_sim}")
    elif field != "own":
        raise ValueError(f"field must be 'jax' or 'own', not {field!r}")
    t0 = time.perf_counter()
    with Bf16MatmulInputs() if bf16_matmul_inputs else nullcontext():
        out = dense_radio.run(cfg, device=device, field_weights=weights,
                              on_run=on_run)
    out["wall_s"] = time.perf_counter() - t0
    out["field"] = field
    out["matmul_inputs"] = "bfloat16" if bf16_matmul_inputs else "float32"
    out["n_sweeps"] = cfg.n_sweeps
    out.update(stamp(device))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--traj", default="square_3D", choices=sorted(N_STEPS))
    ap.add_argument("--mc", type=int, default=100)
    ap.add_argument("--sweeps", type=int, default=50)
    ap.add_argument("--field", default="jax", choices=["jax", "own"])
    ap.add_argument("--bf16-matmul-inputs", action="store_true",
                    help="round every float32 product's operands to "
                         "bfloat16, as the TPU's default precision did in "
                         "the JAX package's runs (a diagnostic)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--arrays", default=None, metavar="NPZ",
                    help="also write make_line_figures' arrays here")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    cfg = config(args.traj, args.mc, args.sweeps)
    arrays = None
    if args.arrays is not None:
        from .make_line_figures import LineArrays

        arrays = LineArrays(cfg.m_basis)
    emit(run(cfg, args.field, device=args.device, on_run=arrays,
             bf16_matmul_inputs=args.bf16_matmul_inputs), args.out)
    if arrays is not None:
        arrays.save(args.arrays)


if __name__ == "__main__":
    main()
