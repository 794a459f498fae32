"""Problem construction from numpy arrays, per-sweep checkpoints, and the
engines' phase spans and profiling helpers.

The JAX package's ``utils/cache.py`` (XLA's persistent compilation cache)
has no counterpart here: the port compiles its CUDA kernels once per
source and flag set into ``rbslam_tpu_torch/_build/`` and loads them from
there on later runs (``kernels/_lib.py``), which is the job that cache
does for compiled XLA programs.
"""

from .checkpoint import latest_step, load_checkpoint, save_checkpoint
from .interop import (
    Problem,
    ekf_inputs,
    problem_from_numpy,
    radio_problem_from_numpy,
)
from .profiling import phase_annotation, recording, trace_to

__all__ = ["Problem", "ekf_inputs", "problem_from_numpy",
           "radio_problem_from_numpy", "save_checkpoint", "load_checkpoint",
           "latest_step", "phase_annotation", "recording", "trace_to"]
