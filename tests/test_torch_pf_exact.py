"""Localization on a fixed magnetic map with the exact GP predictive
(engines/pf.py with models/terrain.py::make_terrain_model), as the
benchmark's cell ``maglocal_exact_n65536`` runs it, at a CPU size
(N_P = 256, m = 64, T = 12; the kernels' plain versions): the program
against the plain reference (benchmark/reference/pf_localization_exact.py)
under the cell's limits, in the ``sum`` mode and one ``product`` case;
faults the limits catch; the ``pf`` span tree; the readers of the cell's
per-layer metrics on hand-made spans; the imports of the reference and the
harness. On a card (marker ``gpu``): the exact model's field rows from K4
against ``grad_blocks``, and K4 launched once a weight evaluation."""

import json
import math
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from benchmark import control, run, spec  # noqa: E402
from benchmark.spans import Phase, SpanCall  # noqa: E402
from rbslam_tpu_torch.gp import fit_scalar_potential_gp  # noqa: E402
from rbslam_tpu_torch.kernels import _lib  # noqa: E402
from rbslam_tpu_torch.kernels.predictive import (  # noqa: E402
    gp_predictive,
    gp_predictive_plain,
    pack_predictive,
)
from rbslam_tpu_torch.utils import profiling, recording  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CELL = "maglocal_exact_n65536"
T, N, M = 12, 256, 64
SMALL = {"config": {"m_basis": M, "data": {"n_test_steps": T, "m_sim": 300}},
         "traffic": {"n_particles": N}}
PRODUCT = {**SMALL, "config": {**SMALL["config"], "weight_mode": "product"}}
LIMITS = spec.workload(spec.benchmark(), CELL)["file"]["limits"]


def _cell(small=SMALL, seed=3, device="cpu"):
    return run.prepare(CELL, seed, device, small)


@pytest.mark.parametrize("small,seed", [(SMALL, 11), (SMALL, 2**31 + 5),
                                        (PRODUCT, 12)],
                         ids=["sum", "sum_large_seed", "product"])
def test_reference_agrees_with_the_port_on_the_cpu(small, seed):
    got = control.reading(CELL, seed, False, "cpu", small)
    for name, limit in LIMITS.items():
        assert math.isfinite(got[name]) and got[name] <= limit, (name, got)


def _broken_run(monkeypatch, target, replacement):
    monkeypatch.setattr(target[0], target[1], replacement)
    return run.run(CELL, 77, 0.1, False, device="cpu", overrides=SMALL)


def _fails(r, *names):
    """Not correct, by the comparison: a completed call and one of
    ``names`` over its limit."""
    assert r["correct"] is False and r["failed"] == 0
    assert any(r["checks"][n]["value"] > r["checks"][n]["limit"]
               for n in names), r["checks"]


def test_mean_only_weights_are_not_correct(monkeypatch):
    """The predictive variance dropped: the weights of the mean alone."""
    import rbslam_tpu_torch.models.terrain as terrain

    log_weight = terrain._log_weight

    def mean_only(y_t, q, mean_nav, var, sigma2, mode):
        return log_weight(y_t, q, mean_nav, torch.zeros_like(var), sigma2,
                          mode)

    _fails(_broken_run(monkeypatch, (terrain, "_log_weight"), mean_only),
           *LIMITS)


def test_a_map_fitted_on_another_seed_is_not_correct(monkeypatch):
    import rbslam_tpu_torch.gp as gp
    from benchmark.problems import mag_localization

    fit = gp.fit_scalar_potential_gp

    def other_map(x, y, *args, **kwargs):
        config = spec.config("mag_localization_exact")
        config = run._merge(config, SMALL["config"])
        other = mag_localization.build(config, 78, "cpu")
        return fit(x, other.y_map.numpy(), *args, **kwargs)

    _fails(_broken_run(monkeypatch, (gp, "fit_scalar_potential_gp"),
                       other_map), *LIMITS)


def test_weights_normalized_over_half_the_particles_are_not_correct(
        monkeypatch):
    import rbslam_tpu_torch.engines.pf as pf

    def half(logw):
        h = logw.shape[-1] // 2
        logz = torch.logsumexp(logw[..., :h], -1) + math.log(2.0)
        logw_n = logw - logz
        return torch.exp(logw_n), logw_n, logz

    _fails(_broken_run(monkeypatch, (pf, "logsumexp_normalize"), half),
           *LIMITS)


def test_an_altered_draw_is_not_correct(monkeypatch):
    """One particle's ancestor moved by half the ensemble at every step."""
    import rbslam_tpu_torch.engines.pf as pf

    resample = pf.resample_indices

    def altered(u, w, n, scheme):
        ai = resample(u, w, n, scheme).clone()
        ai[0] = (ai[0] + n // 2) % n
        return ai

    _fails(_broken_run(monkeypatch, (pf, "resample_indices"), altered),
           "anc_mean")


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


WEIGHT = ["basis", "predictive", "likelihood"]


def test_pf_spans_nest_as_named():
    setup = _cell()
    with recording() as rec:
        setup.cell.call(setup.noise("call", 0))
    spans = rec.spans
    root = spans[0]
    assert root.name == "pf" and root.parent is None
    assert [s.name for s in spans if s.parent is None] == ["pf"]
    top = _children(spans, root)
    assert [s.name for s in top] == ["step0", "loop", "finish"]
    assert [s.name for s in _children(spans, top[0])] == WEIGHT
    steps = _children(spans, top[1])
    assert [(s.name, s.attrs["t"]) for s in steps] == \
        [("step", t) for t in range(1, T)]
    for s in steps:
        kids = _children(spans, s)
        assert [c.name for c in kids] == ["resample", "dynamics", "weights"]
        assert [c.name for c in _children(spans, kids[2])] == WEIGHT
    predictive = [s for s in spans if s.name == "predictive"]
    assert len(predictive) == T
    assert all(s.attrs == {"rows": 3 * N, "n_lin": M + 3}
               for s in predictive)
    for s in spans:
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_recording_leaves_the_localization_equal():
    setup = _cell()
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


def _phases(device_ns):
    out = {}
    for k, v in device_ns.items():
        out[k] = Phase()
        out[k].device_ns = v
    return out


def _read(metric, spans, device_ns, steps=2):
    ctx = SimpleNamespace(span_call=SpanCall(spans, [], [], 0.0),
                          span_phases=_phases(device_ns), steps=steps)
    return spec.reader(metric).read(ctx)


def test_pf_readers_on_hand_made_spans():
    """``pf.predictive_roofline``: the least time of each ``predictive``
    span's solve (rows n_lin^2 operations at 67 TFLOP/s here) over its
    device time; ``pf.weights_device_ms_per_step``: the device time under
    the ``weights`` spans of a ``pf`` root over their count. Both None
    where the spans are missing."""
    rows, nl = 3 * 65536, 1003
    spans = [_span("pf", 0, None), _span("weights", 1, 0),
             _span("basis", 2, 1), _span("predictive", 3, 1, rows=rows,
                                         n_lin=nl),
             _span("weights", 4, 0),
             _span("predictive", 5, 4, rows=rows, n_lin=nl)]
    least = rows * nl * nl / 67e12
    dev = {1: 1_000_000, 2: 500_000, 3: 6_000_000, 4: 0, 5: 4_000_000}
    assert _read("pf.predictive_roofline", spans, dev) == \
        pytest.approx(100 * 2 * least / 10e-3)
    assert _read("pf.weights_device_ms_per_step", spans, dev) == \
        pytest.approx((1.0 + 0.5 + 6.0 + 4.0) / 2)
    other = [_span("rbpf", 0, None), _span("weights", 1, 0),
             _span("predictive", 2, 1)]
    assert _read("pf.weights_device_ms_per_step", other, {1: 5}) is None
    assert _read("pf.predictive_roofline", other, {2: 5}) is None
    for metric in ("pf.predictive_roofline",
                   "pf.weights_device_ms_per_step"):
        assert spec.reader(metric).read(
            SimpleNamespace(steps=2, span_call=None)) is None


def test_the_launch_plan_names_k4_once_a_weight_evaluation():
    setup = _cell()
    ancestors = torch.zeros((T - 1, N), dtype=torch.int32)
    assert setup.cell.launches(ancestors) == {}      # no kernel on the CPU
    setup.cell.device = torch.device("cuda")         # the plan alone
    plan = setup.cell.launches(ancestors)
    assert list(plan) == ["K4"] and len(plan["K4"]) == T
    launch = plan["K4"][0]
    assert launch.nbytes == N * 3 * 4 + N * 3 * M * 4


def _map_posterior(m, device="cpu", seed=3):
    """The cell's map (its data at a CPU size, its theta, no ML-II) fitted
    with m basis functions on ``device``: (gp, cell setup). L carries the
    real spread of sigma2/k of the cell's posterior."""
    setup = _cell(seed=seed, device=device)
    d = setup.cell.data
    gp = fit_scalar_potential_gp(d.x_map.cpu().numpy(), d.y_map.cpu().numpy(),
                                 m, d.LL, d.theta, optimize=False,
                                 device=device)
    return gp, setup


def _positions(setup, gp, n, device="cpu", seed=0):
    """n centred positions of the cell's initial cloud over the mapped
    area."""
    u = torch.rand((n, 2), generator=torch.Generator().manual_seed(seed))
    x = setup.cell.problem.initial_cloud(setup.cell.data, u.to(device))
    return x[:, :3] - torch.as_tensor(gp.center, dtype=torch.float32,
                                      device=device)


def _solve64(C, L, w, sigma2):
    """mean C w and variance sigma2 diag(C A^-1 C'), A = L L', in float64
    by a triangular solve: the predictive the JAX package computes."""
    C, L, w = C.double(), L.double(), w.double()
    V = torch.linalg.solve_triangular(L, C.reshape(-1, C.shape[-1]).T,
                                      upper=False)
    var = sigma2 * torch.sum(V * V, dim=0)
    return (C @ w).reshape(C.shape[:-1]), var.reshape(C.shape[:-1])


def test_plain_predictive_matches_a_float64_solve_at_n_lin_1003():
    """K12's plain version (float32 L^-1 formed in float64, one product)
    against sigma2 diag(C A^-1 C') and C w from a float64 solve of the
    same float32 L, at the cell's width: variance 1e-5 relative, mean
    1e-5 of its largest magnitude (float32 rounding reads 2-3e-7)."""
    gp, setup = _map_posterior(1000)
    sigma2 = float(gp.theta[3])
    x = _positions(setup, gp, 300)
    g = gp.potential.basis.grad_phi(x)
    assert g.shape == (300, 3, 1000)
    mean, var = gp_predictive_plain(pack_predictive(gp.chol, gp.mean_weights,
                                                    sigma2), g)
    mean64, var64 = _solve64(gp.potential.grad_blocks(x), gp.chol,
                             gp.mean_weights, sigma2)
    assert float(((var.double() - var64) / var64).abs().max()) <= 1e-5
    assert float((mean.double() - mean64).abs().max()) <= \
        1e-5 * float(mean64.abs().max())


@pytest.mark.parametrize("n,m", [(45, 8), (1, 125), (43, 130)],
                         ids=["rows_135", "one_particle", "m_130"])
def test_plain_predictive_identity_columns_and_ragged_rows(n, m):
    """A random lower-triangular L and rows that fill no tile of 128 (nor,
    at m = 125 and 130, a column tile): the table holds L^-1 transposed
    and w, zero elsewhere; with g = 0 the rows are the identity columns
    alone (mean w[a], variance sigma2 ||L^-1 e_a||^2); and any g agrees
    with the float64 solve."""
    gen = torch.Generator().manual_seed(n + m)
    n_lin = m + 3
    A = torch.randn((n_lin, n_lin), generator=gen, dtype=torch.float64)
    L = torch.linalg.cholesky(A @ A.T / n_lin
                              + torch.eye(n_lin, dtype=torch.float64)).float()
    w = torch.randn(n_lin, generator=gen)
    pc = pack_predictive(L, w, 0.7)
    inv = torch.linalg.inv(L.double())
    assert pc.m == m and pc.table.shape == (3 + -(-m // 32) * 32,
                                            -(-(n_lin + 1) // 128) * 128)
    torch.testing.assert_close(pc.table[:n_lin, :n_lin],
                               inv.T.float(), rtol=1e-6, atol=1e-6)
    assert torch.equal(pc.table[:n_lin, n_lin], w)
    assert not pc.table[n_lin:].any() and not pc.table[:, n_lin + 1:].any()
    mean0, var0 = gp_predictive(pc, torch.zeros((n, 3, m)))
    assert torch.equal(mean0, w[:3].expand(n, 3))
    torch.testing.assert_close(var0, (0.7 * torch.sum(inv[:, :3] ** 2, 0))
                               .float().expand(n, 3), rtol=1e-6, atol=0)
    g = torch.randn((n, 3, m), generator=gen)
    mean, var = gp_predictive(pc, g)
    C = torch.cat([torch.eye(3).expand(n, 3, 3), g], dim=-1)
    mean64, var64 = _solve64(C, L, w, 0.7)
    assert mean.shape == var.shape == (n, 3)
    torch.testing.assert_close(var.double(), var64, rtol=1e-5, atol=0)
    torch.testing.assert_close(mean.double(), mean64, rtol=0,
                               atol=1e-5 * float(mean64.abs().max()))


def test_predictive_refuses_what_the_kernel_does_not_take():
    pc = pack_predictive(torch.eye(11), torch.ones(11), 1.0)
    for bad, err in ((torch.zeros((4, 3, 8), dtype=torch.float64), TypeError),
                     (torch.zeros((4, 2, 8)), ValueError),
                     (torch.zeros((4, 3, 9)), ValueError),
                     (torch.zeros((4, 8, 3)).transpose(1, 2), ValueError)):
        with pytest.raises(err):
            gp_predictive(pc, bad)
    with pytest.raises(ValueError):
        pack_predictive(torch.eye(11), torch.ones(10), 1.0)


def _top_level_modules(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", f"import sys; sys.path.insert(0, "
         f"{str(ROOT)!r}); {code}; import json; print(json.dumps(sorted("
         "{m.split('.')[0] for m in sys.modules})))"],
        check=True, capture_output=True, text=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_reference_and_problem_load_nothing_of_the_program():
    tops = _top_level_modules(
        "import benchmark.reference.pf_localization_exact, "
        "benchmark.problems.mag_localization, "
        "benchmark.engines.run_pf_localization, benchmark.roofline_pf")
    assert not tops & {"jax", "jaxlib", "flax", "rbslam_tpu",
                       "rbslam_tpu_torch"}


def test_the_harness_runs_the_cell_without_jax():
    tops = _top_level_modules(
        "from benchmark import run; "
        f"r = run.run({CELL!r}, 5, 0.1, False, device='cpu', "
        f"overrides={SMALL!r}); assert r['correct'], r['checks']")
    assert "rbslam_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "rbslam_tpu"}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (sm_90a): K4 has no CPU mode; its "
                    "plain version serves the CPU tests above")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_k4_field_rows_equal_grad_blocks_on_the_card(card, monkeypatch):
    """The exact model's C = [I_3 | grad phi] from K4 against
    ``grad_blocks`` on the same centred positions, at the cell's width
    (m = 1000) and at 512 particles, where K4 runs its table form as in
    the cell (from 264 particles on): 1e-4 of the largest magnitude (both
    float32, phases rounded in another order); one K4 launch a weight
    evaluation, T a call."""
    import rbslam_tpu_torch.models.terrain as terrain
    from rbslam_tpu_torch.kernels.basis_eval import (_basis_plan,
                                                     pack_basis_constants)

    n = 512
    small = {"config": {"data": {"n_test_steps": T}},
             "traffic": {"n_particles": n}}
    setup = _cell(small, device=card)
    model = setup.cell.model
    counts = pack_basis_constants(setup.cell.potential.basis, "cpu").counts
    assert _basis_plan(False, n, 3, 1000, 0, 4, counts) == (1, 1)
    seen = []
    grad_basis = terrain.grad_basis

    def spy(consts, x):
        g = grad_basis(consts, x)
        seen.append((x.clone(), g.clone()))
        return g

    monkeypatch.setattr(terrain, "grad_basis", spy)
    xn = setup.cell.problem.initial_cloud(
        setup.cell.data, torch.rand((n, 2), device=card))
    model.log_weight(setup.cell.data.y[0], xn)
    (x, g), = seen
    assert g.shape == (n, 3, 1000)
    ref = setup.cell.potential.grad_blocks(x)
    C = torch.cat([torch.eye(3, device=card).expand(n, 3, 3), g], dim=-1)
    scale = float(ref.abs().max())
    assert float((C - ref).abs().max()) <= 1e-4 * scale
    monkeypatch.undo()
    before = _lib.launch_counts()["grad_basis"]
    setup.cell.call(setup.noise("call", 0))
    torch.cuda.synchronize()
    assert _lib.launch_counts()["grad_basis"] - before == T


def _card_case(card, n, m):
    """K4's rows at n positions of the cell's cloud and the packed map of m
    basis functions, on the card."""
    from rbslam_tpu_torch.kernels.basis_eval import (grad_basis,
                                                     pack_basis_constants)

    gp, setup = _map_posterior(m, device=card)
    x = _positions(setup, gp, n, device=card)
    g = grad_basis(pack_basis_constants(gp.potential.basis, card),
                   x.contiguous())
    return g, pack_predictive(gp.chol, gp.mean_weights, float(gp.theta[3]))


@pytest.mark.gpu
@pytest.mark.parametrize("n,m", [(512, 1000), (65536, 1000), (1001, 997)],
                         ids=["n512", "n65536", "ragged_n_lin_1000"])
def test_k12_matches_its_plain_version_on_the_card(card, n, m):
    """K12 against its plain version on the card (the same table; cuBLAS's
    float32 product, TF32 off), at the cell's width and a ragged one (n_lin
    1000, 3003 rows): variance 1e-5 relative, mean 1e-5 of its largest
    magnitude (they differ by the float32 sums' order, 3e-7 at the cell's
    shape); two launches bit-equal."""
    g, pc = _card_case(card, n, m)
    before = _lib.launch_counts()["predictive"]
    mean, var = gp_predictive(pc, g)
    mean2, var2 = gp_predictive(pc, g)
    torch.cuda.synchronize()
    assert _lib.launch_counts()["predictive"] - before == 2
    assert torch.equal(mean, mean2) and torch.equal(var, var2)
    mean_p, var_p = gp_predictive_plain(pc, g)
    assert mean.shape == var.shape == (n, 3)
    assert bool(torch.isfinite(var).all()) and bool((var > 0).all())
    assert float(((var - var_p) / var_p).abs().max()) <= 1e-5
    assert float((mean - mean_p).abs().max()) <= \
        1e-5 * float(mean_p.abs().max())


@pytest.mark.gpu
def test_k4_and_k12_launch_once_a_weight_evaluation(card):
    """On the PF's main path of the cell (T = 160; 512 particles), K4 and
    K12 each launch once a weight evaluation, 160 a call, and the exact
    model's predictive runs no other kernel of the port."""
    setup = _cell({"traffic": {"n_particles": 512}}, device=card)
    zero = dict.fromkeys(_lib.KERNEL_NAMES, 0)
    _lib.reset_launch_counts()
    setup.cell.call(setup.noise("call", 0))
    torch.cuda.synchronize()
    steps = setup.cell.steps_per_call
    assert steps == 160
    assert _lib.launch_counts() == {**zero, "grad_basis": steps,
                                    "predictive": steps}
