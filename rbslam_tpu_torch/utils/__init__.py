from .interop import Problem, problem_from_numpy, radio_problem_from_numpy

__all__ = ["Problem", "problem_from_numpy", "radio_problem_from_numpy"]
