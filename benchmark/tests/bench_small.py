"""The cell the harness tests run, and its small CPU size."""

from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELL = "mag_lowrank_n12288"
# the cell's configuration at a size the CPU runs in about a second a call
# (n_lin 64, padded to 128 on the kernel path; T = 24; rebase period 4)
SMALL = {"config": {"m_basis": 61,
                    "data": {"n_laps": 1, "n_per_lap": 24, "m_sim": 300},
                    "engine_config": {"lowrank_period": 4}},
         "traffic": {"n_particles": 64}}

SMOOTHER = "mag_smoother_n100"
# the smoother's configuration at a CPU size: 16 particles, 3 sweeps
SMALL_SMOOTHER = {"config": {"m_basis": 61,
                             "data": {"n_laps": 1, "n_per_lap": 24,
                                      "m_sim": 300}},
                  "traffic": {"n_particles": 16, "n_sweeps": 3}}
