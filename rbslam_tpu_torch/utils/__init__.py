from .interop import (
    Problem,
    ekf_inputs,
    problem_from_numpy,
    radio_problem_from_numpy,
)

__all__ = ["Problem", "ekf_inputs", "problem_from_numpy",
           "radio_problem_from_numpy"]
