"""Dense radio SLAM smoothed by the conditional particle filter with
ancestor sampling (engines/rbps.py::run_rbps with models/radio2d.py), as
the benchmark's cell ``radio_cpfas_n16384`` runs it, at a CPU size
(N_P = 64, N_K = 2, m = 16, T = 48; K6's plain version): the harness's
correctness check on two seeds; faults the limits catch (in the ancestor
weights, the resampling, the kept pick, the trajectories, the map and the
dynamics); the CPF-AS span
tree, and a call left bit-equal by recording it; the readers of the cell's
per-layer metrics on hand-made spans; the imports of the reference and the
problem."""

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from benchmark import roofline_cpfas, run, spec  # noqa: E402
from benchmark.problems import dense_radio  # noqa: E402
from benchmark.spans import Phase, SpanCall  # noqa: E402
from rbslam_tpu_torch.utils import profiling, recording  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "radio_cpfas_n16384"
N, K, M = 64, 2, 16
T = 48
SMALL = {"config": {"m_basis": M, "data": {"m_sim": 300}},
         "traffic": {"n_particles": N, "n_sweeps": K}}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the tensors here are tiny, and test workers
    that share the host's cores would otherwise oversubscribe them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(seed=77):
    return run.run(CELL, seed, 0.1, False, device="cpu", overrides=SMALL)


@pytest.mark.parametrize("seed", [11, 2**31 + 5], ids=["seed", "large_seed"])
def test_the_harness_judges_the_small_cell_correct(seed):
    r = _run(seed)
    assert r["correct"] is True, r["checks"]
    assert r["failed"] == 0 and not r["errors"]


def _fails(r):
    """Not correct, by the comparison: a completed call and a compared
    number over its limit."""
    assert r["correct"] is False and r["failed"] == 0
    assert any(c["value"] > c["limit"] for c in r["checks"].values()), \
        r["checks"]


def test_ancestor_weights_without_the_future_term_are_not_correct(
        monkeypatch):
    import rbslam_tpu_torch.engines.rbps as rbps

    def no_future(C_stack, y_stack, t_idx, xl, *args):
        n = xl.shape[0]
        return torch.zeros(n), torch.zeros(n, dtype=torch.bool)

    monkeypatch.setattr(rbps, "_dense_future_log_weights", no_future)
    _fails(_run())


def test_a_moved_ancestor_draw_is_not_correct(monkeypatch):
    """The pinned particle's ancestor (and the kept trajectory) moved by
    half the ensemble."""
    import rbslam_tpu_torch.engines.rbps as rbps

    draw = rbps.sample_categorical

    def moved(u, w):
        return (draw(u, w) + w.shape[0] // 2) % w.shape[0]

    monkeypatch.setattr(rbps, "sample_categorical", moved)
    _fails(_run())


def _identity(rbps):
    return lambda u, w, n, scheme: torch.arange(n)


def _first_half(rbps):
    draw = rbps.resample_indices

    def first_half(u, w, n, scheme):
        return draw(u, w * (torch.arange(n) < n // 2), n, scheme)
    return first_half


def _moved_pick(rbps):
    finish = rbps._finish_sweep

    def moved(*args):
        *rest, draws = args
        pick = draws.pick
        return finish(*rest, draws._replace(
            pick=lambda: (pick() + 0.5) % 1.0))
    return moved


def _unfollowed(rbps):
    return lambda xn_hist, ancestors: xn_hist.clone()


@pytest.mark.parametrize("fault", ["identity_resampler",
                                   "half_resampler", "moved_pick",
                                   "unfollowed_trajectories"])
def test_a_fault_outside_the_ancestor_draw_is_not_correct(monkeypatch,
                                                          fault):
    """Resampling that keeps every particle, or draws from the first half
    of the ensemble alone; the kept trajectory's index moved; the kept
    trajectory read at its final index at every step instead of along its
    ancestors."""
    import rbslam_tpu_torch.engines.rbps as rbps

    name, make = {"identity_resampler": ("resample_indices", _identity),
                  "half_resampler": ("resample_indices", _first_half),
                  "moved_pick": ("_finish_sweep", _moved_pick),
                  "unfollowed_trajectories":
                      ("reconstruct_trajectories", _unfollowed)}[fault]
    monkeypatch.setattr(rbps, name, make(rbps))
    _fails(_run())


def _program_inputs(monkeypatch, change):
    """Hand the program its problem with ``change(kwargs)`` applied to the
    arrays the cell builds it from (the reference keeps the true ones)."""
    import rbslam_tpu_torch.utils.interop as interop

    build = interop.radio_problem_from_numpy

    def changed(NN, L, eigenvalues, center, k, Q, R, dt, dx, y, init_state,
                *, device):
        a = dict(Q=Q, y=y)
        change(a)
        return build(NN, L, eigenvalues, center, k, a["Q"], R, dt, dx,
                     a["y"], init_state, device=device)

    monkeypatch.setattr(interop, "radio_problem_from_numpy", changed)


def test_a_map_from_another_seed_is_not_correct(monkeypatch):
    config = run._merge(spec.config("dense_radio_cpfas"), SMALL["config"])
    other = dense_radio.make(config, torch.Generator().manual_seed(78), "cpu")
    _program_inputs(monkeypatch,
                    lambda a: a.update(y=other.y.numpy()))
    _fails(_run())


def test_the_heading_spikes_dropped_from_q_are_not_correct(monkeypatch):
    _program_inputs(monkeypatch,
                    lambda a: a.update(Q=a["Q"].clip(max=a["Q"].min())))
    _fails(_run())


def test_the_problem_spikes_the_heading_noise_at_the_corners():
    config = run._merge(spec.config("dense_radio_cpfas"), SMALL["config"])
    q = dense_radio.heading_noise(config["data"])
    assert q.shape == (T - 1,)
    assert sorted(q.argsort()[-3:].tolist()) == [11, 23, 35]
    assert q.max() == pytest.approx(0.01) and q.min() == pytest.approx(1e-6)
    d = dense_radio.make(config, torch.Generator().manual_seed(3), "cpu")
    assert d.dx.dtype == d.y.dtype == torch.float32
    assert d.dx.shape == (T - 1, 3) and d.y.shape == (T, 1)
    assert torch.equal(d.x0[:2], d.truth[0]) and float(d.x0[2]) == 0.0


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


def test_cpfas_spans_nest_as_named():
    setup = run.prepare(CELL, 3, "cpu", SMALL)
    with recording() as rec:
        setup.cell.call(setup.noise("call", 0))
    spans = rec.spans
    assert [s.name for s in spans if s.parent is None] == ["rbps"]
    sweeps = _children(spans, spans[0])
    assert [(s.name, s.attrs["k"]) for s in sweeps] == \
        [("sweep", k) for k in range(K)]
    for k, sweep in enumerate(sweeps):
        steps = _children(spans, sweep)
        assert [(s.name, s.attrs["t"]) for s in steps] == \
            [("step", t) for t in range(1, T)]
        for s in steps:
            kids = _children(spans, s)
            names = ["resample", "ancestor", "dynamics", "update", "weights"]
            if k == 0:
                names.remove("ancestor")
            assert [c.name for c in kids] == names
            if k:
                t = s.attrs["t"]
                assert kids[1].attrs == {"rows": T - t, "width": T,
                                         "n_lin": M, "n": N}
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_recording_leaves_the_smoother_equal():
    setup = run.prepare(CELL, 4, "cpu", SMALL)
    noise = setup.noise("call", 1)
    off = setup.cell.call(noise)
    with recording() as rec:
        on = setup.cell.call(noise)
    assert rec.spans and profiling._recorder is None
    for name, a, b in zip(off._fields, off, on):
        assert torch.equal(a, b), name


def _span(name, id_, parent, call=0, **attrs):
    s = profiling.Span(name, attrs, id_, parent, call)
    s.start_ns, s.end_ns = 10 * id_, 10 * id_ + 5
    return s


def _read(metric, spans, device_ns, steps=2):
    phases = {}
    for k, v in device_ns.items():
        phases[k] = Phase()
        phases[k].device_ns = v
    ctx = SimpleNamespace(span_call=SpanCall(spans, [], [], 0.0),
                          span_phases=phases, steps=steps)
    return spec.reader(metric).read(ctx)


def test_cpfas_readers_on_hand_made_spans():
    """``cpfas.ancestor_device_ms_per_step``: the device time under the
    CPF-AS ``ancestor`` spans over their count; ``cpfas.ancestor_roofline``:
    their least time (4 min(nl (nl + 1) / 2, rows nl) bytes a particle at
    3.35 TB/s here) over that device time. Both None without such spans
    (the information form's ``ancestor`` spans record no rows)."""
    n, nl = 16384, 128
    spans = [_span("rbps", 0, None), _span("sweep", 1, 0),
             _span("step", 2, 1), _span("ancestor", 3, 2, rows=47, width=48,
                                        n_lin=nl, n=n),
             _span("update", 4, 2), _span("step", 5, 1),
             _span("ancestor", 6, 5, rows=1, width=48, n_lin=nl, n=n)]
    dev = {3: 4_000_000, 4: 6_000_000, 6: 2_000_000}
    assert _read("cpfas.ancestor_device_ms_per_step", spans, dev) == \
        pytest.approx((4.0 + 2.0) / 2)
    least = (4 * min(nl * (nl + 1) // 2, 47 * nl) * n
             + 4 * min(nl * (nl + 1) // 2, 1 * nl) * n) / 3.35e12
    assert _read("cpfas.ancestor_roofline", spans, dev) == \
        pytest.approx(100 * least / 6e-3)
    info = [_span("rbps", 0, None), _span("sweep", 1, 0),
            _span("ancestor", 2, 1)]
    for metric in ("cpfas.ancestor_device_ms_per_step",
                   "cpfas.ancestor_roofline"):
        assert _read(metric, info, {2: 5}) is None
        assert spec.reader(metric).read(
            SimpleNamespace(steps=2, span_call=None)) is None


def test_the_ancestor_bound_reads_the_smaller_operand():
    """Wide future systems read the map's symmetric half; narrow ones its
    product with the live rows; operations 2 rows n_lin a particle."""
    wide, narrow = roofline_cpfas.ancestor(200, 128, 10), \
        roofline_cpfas.ancestor(3, 128, 10)
    assert wide.nbytes == 4 * 128 * 129 // 2 * 10
    assert narrow.nbytes == 4 * 3 * 128 * 10
    assert narrow.flops == 2 * 3 * 128 * 10 and narrow.itemsize == 4


def _top_level_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{str(ROOT)!r}); {code}; import json; print(json.dumps(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        check=True, capture_output=True, text=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_and_problem_load_nothing_of_the_program():
    tops = _top_level_modules(
        "import benchmark.reference.rbps_cpfas_dense, "
        "benchmark.problems.dense_radio, benchmark.engines.run_rbps, "
        "benchmark.roofline_cpfas")
    assert not tops & {"jax", "jaxlib", "flax", "rbslam_tpu",
                       "rbslam_tpu_torch"}
