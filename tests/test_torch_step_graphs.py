"""The information-form smoother's step as a CUDA-graph replay
(engines/rbps_info.py: ``_info_step``, ``_StepGraphs``, ``_graphs_engage``).

On the CPU: the rule that decides where the graph engages, as a pure
function; the graph runner with a stand-in for the capture that replays
the captured Python instead (the same static buffers, per-sweep refills
and device-side step index, so a tensor that a later sweep fails to refill
is read stale there as a CUDA graph would read it) against the eager loop,
bit for bit, with the spans of both runners; and the launch counter of a
replay. On a card (marker ``gpu``, no JAX): the real graphs against the
eager loop, bit for bit, on mag3d (injected draws and a CUDA generator)
and on radio2d (ny = 1), with equal launch counts and the replay flag on
every step but the warm-up ones."""

import pytest

torch = pytest.importorskip("torch")

from rbslam_tpu_torch.engines import RBPSConfig  # noqa: E402
from rbslam_tpu_torch.engines import rbps_info  # noqa: E402
from rbslam_tpu_torch.engines import run_rbps_information_form  # noqa: E402
from rbslam_tpu_torch.kernels import _lib  # noqa: E402
from rbslam_tpu_torch.utils import recording  # noqa: E402
from rbslam_tpu_torch.workloads import dense_radio  # noqa: E402
from rbslam_tpu_torch.workloads.dense_mag import build_problem  # noqa: E402

N_P, T, N_K = 24, 12, 3


class PythonGraphs(rbps_info._StepGraphs):
    """The graph runner with the capture replaced by the captured Python
    itself: each replay calls the function the capture was handed, so it
    reads what that first sweep of its kind referenced."""

    @staticmethod
    def _on_side_stream(device, fn):
        fn()

    def _capture(self, device, fn):
        return fn


_RULE = rbps_info._graphs_engage


def _engage_as_on_a_card(device, *args):
    return _RULE(torch.device("cuda"), *args)


def _problem(model, device):
    if model == "radio2d":
        cfg = dense_radio.DenseRadioConfig(n_steps=T, n_particles=N_P,
                                           m_basis=32, m_sim=256)
        return dense_radio.build_problem(
            cfg, torch.Generator().manual_seed(1), device=device)[0]
    return build_problem(125, T, seed=1, m_sim=512, device=device)[0]


def _noise(problem, resampling, device, seed=11):
    gen = torch.Generator(device=device).manual_seed(seed)
    u_shape = (N_K, T - 1) if resampling == "systematic" \
        else (N_K, T - 1, N_P)
    return (torch.rand(u_shape, generator=gen, device=device),
            torch.randn((N_K, T - 1, N_P, problem.model.n_noise),
                        generator=gen, device=device),
            torch.rand((N_K, T - 1), generator=gen, device=device),
            torch.rand((N_K,), generator=gen, device=device))


def _run(problem, cfg, device, noise=None, generator=None):
    """One call under the span recorder: (result, launch counts, spans)."""
    _lib.reset_launch_counts()
    with recording() as rec:
        out = run_rbps_information_form(*problem.rbpf_args(), cfg,
                                        generator=generator, device=device,
                                        noise=noise)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, _lib.launch_counts(), rec.spans


def _assert_bit_equal(a, b):
    for field, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), field


def _step_flags(spans):
    """{(sweep k, t): graph flag} of the call's step spans, and whether any
    replayed step holds a child span."""
    by_id = {s.id: s for s in spans}
    flags = {}
    for s in spans:
        if s.name == "step":
            flags[(by_id[s.parent].attrs["k"], s.attrs["t"])] = \
                s.attrs["graph"]
    replayed = {s.id for s in spans if s.name == "step" and s.attrs["graph"]}
    return flags, any(s.parent in replayed for s in spans)


# --- where the graph engages ----------------------------------------------

@pytest.mark.parametrize("case, want", [
    (dict(), True),
    (dict(ny=1), True),
    (dict(device="cpu"), False),
    (dict(mesh=object()), False),
    (dict(ancestor_form="cholesky"), False),
    (dict(ancestor_form="cholesky", is_first=True), True),
    (dict(ny=4), False),
    (dict(ny=4, is_first=True), False),
])
def test_engagement_rule(case, want):
    """On for one CUDA device with the small-ny update and the Woodbury
    form (the first sweep in either form); off on the CPU, for a mesh,
    for the Cholesky form's conditioned sweeps and for ny > 3."""
    args = dict(device="cuda", mesh=None, ny=3, ancestor_form="woodbury",
                is_first=False, injected=True)
    args.update(case)
    assert rbps_info._graphs_engage(**args) is want


@pytest.mark.parametrize("register", [False, True])
def test_engagement_rule_for_a_generator(register, monkeypatch):
    """Drawn from a generator, the steps replay only where this torch can
    register the generator with a capture; injected draws need nothing."""
    graph_type = type("Graph", (), {"register_generator_state": None}
                      if register else {})
    monkeypatch.setattr(torch.cuda, "CUDAGraph", graph_type)
    rule = dict(device="cuda", mesh=None, ny=3, ancestor_form="woodbury",
                is_first=False)
    assert rbps_info._graphs_engage(**rule, injected=False) is register
    assert rbps_info._graphs_engage(**rule, injected=True) is True


def test_count_replay_adds_the_captured_launches():
    _lib.reset_launch_counts()
    _lib.count_replay({"grad_basis": 2, "phi_basis": 1})
    _lib.count_replay({"grad_basis": 2})
    counts = _lib.launch_counts()
    assert counts["grad_basis"] == 4 and counts["phi_basis"] == 1
    assert sum(counts.values()) == 5
    _lib.reset_launch_counts()


# --- the graph runner, with the captured Python replayed ------------------

CASES = {
    "woodbury": ("mag3d", dict(resampling="systematic")),
    "woodbury_multinomial": ("mag3d", dict(resampling="multinomial")),
    "woodbury_no_precompute": ("mag3d", dict(resampling="systematic",
                                             suffix_precompute=False)),
    "woodbury_bf16": ("mag3d", dict(resampling="systematic",
                                    cov_dtype="bfloat16")),
    "cholesky": ("mag3d", dict(resampling="systematic",
                               ancestor_form="cholesky")),
    "radio2d": ("radio2d", dict(resampling="multinomial")),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_steps_equal_the_eager_loop(case, monkeypatch):
    """The graph runner (static buffers refilled by each sweep's set-up,
    the step index on the device, one capture of each sweep kind) with its
    capture's Python replayed, against the eager loop: every output equal
    bit for bit. Steps replay from the second step of the first sweep of
    each kind on; the Cholesky form's conditioned sweeps stay eager; a
    replayed step records no child phase."""
    model, kw = CASES[case]
    problem = _problem(model, "cpu")
    cfg = RBPSConfig(n_particles=N_P, n_sweeps=N_K, **kw)
    noise = _noise(problem, cfg.resampling, "cpu")
    eager, _, eager_spans = _run(problem, cfg, "cpu", noise)
    monkeypatch.setattr(rbps_info, "_StepGraphs", PythonGraphs)
    monkeypatch.setattr(rbps_info, "_graphs_engage", _engage_as_on_a_card)
    replayed, _, spans = _run(problem, cfg, "cpu", noise)
    _assert_bit_equal(replayed, eager)

    flags, nested = _step_flags(spans)
    eager_flags, _ = _step_flags(eager_spans)
    assert set(flags) == set(eager_flags) == {
        (k, t) for k in range(N_K) for t in range(1, T)}
    assert not any(eager_flags.values())
    conditioned = cfg.ancestor_form == "woodbury"
    warm = {(0, 1)} | ({(1, 1)} if conditioned else
                       {(k, t) for k in range(1, N_K) for t in range(1, T)})
    assert {key for key, graph in flags.items() if not graph} == warm
    assert not nested


def test_graph_buffers_are_released_with_the_call(monkeypatch):
    """The call's graphs and static buffers go when it returns; the outputs
    hold none of them (the next sweep would overwrite them)."""
    made = []

    class Kept(PythonGraphs):
        def __init__(self, *args):
            super().__init__(*args)
            made.append(self)

    problem = _problem("mag3d", "cpu")
    cfg = RBPSConfig(n_particles=N_P, n_sweeps=N_K, resampling="systematic")
    monkeypatch.setattr(rbps_info, "_StepGraphs", Kept)
    monkeypatch.setattr(rbps_info, "_graphs_engage", _engage_as_on_a_card)
    out, _, _ = _run(problem, cfg, "cpu", _noise(problem, "systematic",
                                                 "cpu"))
    (graphs,) = made
    assert not graphs._buffers and not graphs._graphs
    # each sweep's ess and ancestors are its own, not a shared buffer's
    assert len({a.data_ptr() for a in out.ess}) == N_K


# --- on the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph captures only on a "
                    "card; the tests above replay the captured Python")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["mag3d", "mag3d_generator", "radio2d"])
def test_graph_replays_equal_the_eager_loop_on_the_card(card, case,
                                                        monkeypatch):
    """Woodbury form, N_P = 24, T = 12, 3 sweeps: the CUDA graphs against
    the eager loop (the engagement rule switched off) on the same draws
    (the ``noise`` seam, or a CUDA generator seeded alike): ancestors,
    kept trajectories, XNK, XLK, PK, ess and retries bit-equal, launch
    counts equal, and the replay flag on every step but the first step of
    the first and of the second sweep."""
    model = "radio2d" if case == "radio2d" else "mag3d"
    problem = _problem(model, card)
    resampling = "multinomial" if model == "radio2d" else "systematic"
    cfg = RBPSConfig(n_particles=N_P, n_sweeps=N_K, resampling=resampling)
    noise = None if case.endswith("generator") else \
        _noise(problem, resampling, card)

    def call():
        gen = torch.Generator(device=card).manual_seed(5)
        return _run(problem, cfg, card, noise,
                    None if noise is not None else gen)

    graph, graph_counts, spans = call()
    monkeypatch.setattr(rbps_info, "_graphs_engage", lambda *a: False)
    eager, eager_counts, _ = call()
    _assert_bit_equal(graph, eager)
    assert graph_counts == eager_counts
    assert graph_counts["grad_basis" if model == "mag3d" else
                        "phi_basis"] == N_K * T + N_K - 1
    flags, nested = _step_flags(spans)
    assert {key for key, g in flags.items() if not g} == {(0, 1), (1, 1)}
    assert len(flags) == N_K * (T - 1) and not nested
