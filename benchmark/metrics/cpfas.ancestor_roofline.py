"""cpfas.ancestor_roofline (%): the CPF-AS smoother's ancestor weights over
their roofline in the span call (spans.py): the sum over the ``ancestor``
spans of their least time (roofline_cpfas.py, from the ``rows``, ``n_lin``
and ``n`` each span records: the live rows of the future readings, the
map's width and the particles) over the device time of the operations
launched inside them. None where no span records them."""

from benchmark import roofline_cpfas, spans


def read(ctx):
    call = spans.call_of(ctx)
    if call is None:
        return None
    found = roofline_cpfas.ancestor_spans(call)
    if not found:
        return None
    device = spans._subtree_sum(call, ctx.span_phases, "device_ns")
    least = sum(roofline_cpfas.ancestor(s.attrs["rows"], s.attrs["n_lin"],
                                        s.attrs["n"]).least_s()
                for s in found)
    device_ns = sum(device[s.id] for s in found)
    if not device_ns:
        return None
    return 100.0 * least / (device_ns * 1e-9)
