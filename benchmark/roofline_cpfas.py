"""The yardsticks of the CPF-AS smoother's cell (``engines/rbps.py::
run_rbps``): the least bytes and operations of the pinned particle's
ancestor weights (span ``ancestor``), float32, at the peaks of
roofline.py.

**The ancestor weights.** At step t every particle's weight carries the
likelihood of the readings still to come along the reference,
log N(y_t:T; C m, C P C' + R), C the ``rows`` = (T - t) ny live rows of
basis functions and N(m, P) the particle's map posterior of width
``n_lin``. The particles' maps are distinct (each was updated with its own
readings at its own poses), so an exact evaluation reads, for each
particle, what its map's covariance contributes to C P C': either the
covariance itself, of which the symmetric half, n_lin (n_lin + 1) / 2
numbers, is all there is to read (the information form carries a matrix
of the same size), or its product with the live rows, rows n_lin numbers,
whichever is smaller; it then forms C P C' from that, at least rows n_lin
multiply-adds (one for each number of C P, the product the smaller
operand needs). The bound counts those bytes at float32 and those
operations as two each, and leaves out C, the mean, the readings and the
Cholesky of the rows-wide system, so it lies below what any form that
keeps the map posterior whole, the program's or the information form,
can take: a share of it cannot pass 1. (A form that carried each
particle's C P C' itself, rows (rows + 1) / 2 numbers, would read less
than this bound counts; no form of the port does.)
"""

from __future__ import annotations

from .roofline import Launch


def ancestor(rows: int, n_lin: int, n: int) -> Launch:
    """The ``ancestor`` span of one step over ``n`` particles, float32
    (the 67 TFLOP/s peak)."""
    read = min(n_lin * (n_lin + 1) // 2, rows * n_lin)
    return Launch(4 * read * n, 2 * rows * n_lin * n, 4)


def ancestor_spans(call) -> list:
    """The ``ancestor`` spans of CPF-AS sweeps in a span call (spans.py):
    those that record ``rows``, ``n_lin`` and ``n``, under an ``rbps``
    root (the information-form smoother's ``ancestor`` spans record none
    of them)."""
    return [s for s in call.spans if s.name == "ancestor"
            and {"rows", "n_lin", "n"} <= set(s.attrs)
            and call.spans[s.call].name == "rbps"]

