"""pf.predictive_roofline (%): the exact localization weight's predictive
phase over its roofline in the span call (spans.py): the sum over the
``predictive`` spans of their least time (roofline_pf.py, from the
``rows`` and ``n_lin`` each span records: what the program solved) over
the device time of the operations launched inside them (the solve, the
mean and the variance's sum of squares). None where no span records them:
a program without the spans, or another model."""

from benchmark import roofline_pf, spans


def read(ctx):
    call = spans.call_of(ctx)
    if call is None:
        return None
    least = device_ns = 0.0
    for s in call.spans:
        if s.name != "predictive" or not {"rows", "n_lin"} <= set(s.attrs):
            continue
        least += roofline_pf.predictive(s.attrs["rows"],
                                        s.attrs["n_lin"]).least_s()
        phase = ctx.span_phases.get(s.id)
        device_ns += phase.device_ns if phase is not None else 0
    if not device_ns:
        return None
    return 100.0 * least / (device_ns * 1e-9)
