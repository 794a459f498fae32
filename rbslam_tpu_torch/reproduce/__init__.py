"""Reproduction scripts: the port's counterparts of the JAX package's
paper-reproduction scripts (``scripts/run_mc.py``, ``run_boxplot.py``,
``run_boxplot_lowrank.py``, ``plot_boxplot.py``, ``make_line_figures.py``,
``make_mag_figure.py``) and ``compare``, which holds a port result against
the JAX package's recorded run of the same experiment.

The run scripts compute on the card (``--device cuda``, the default) and
print each result as one JSON line; the figure scripts render on the host
from the arrays and JSON the runs wrote (matplotlib is imported inside the
functions that draw)."""
