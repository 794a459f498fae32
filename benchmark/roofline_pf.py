"""The yardstick of the exact localization weight's predictive phase
(``models/terrain.py::make_terrain_model``, span ``predictive``): the least
bytes and operations of its triangular solve V = L^-1 C' over ``rows``
right-hand sides of width ``n_lin``, float32, at the peaks of roofline.py.

Bytes count C read once and V written once; operations count a
triangular solve's n_lin (n_lin + 1) / 2 multiply-adds a right-hand side
as n_lin^2 (two each, less the diagonal's), below what any implementation
needs, so a share of this bound cannot pass 1. The mean C w and the
variance's sum of squares beside the solve are left out of the bound and
kept in the measured time.
"""

from __future__ import annotations

from .roofline import Launch


def predictive(rows: int, n_lin: int) -> Launch:
    """The predictive span's solve at float32 (the 67 TFLOP/s peak)."""
    return Launch(2 * rows * n_lin * 4, rows * n_lin * n_lin, 4)
