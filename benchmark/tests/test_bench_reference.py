"""The plain reference against the port's CPU run (the kernels' plain
versions) on the benchmark's injected draws at small sizes, and the
harness seeing ``correct`` false when the path under it is broken."""

import math

import pytest
import torch

from benchmark import control, run
from bench_small import CELL, SMALL, SMALL_SMOOTHER, SMOOTHER


def _small(n, period, m=61):
    return {"config": {**SMALL["config"], "m_basis": m,
                       "engine_config": {"lowrank_period": period}},
            "traffic": {"n_particles": n}}


def _smoother(n, n_k):
    return {**SMALL_SMOOTHER,
            "traffic": {"n_particles": n, "n_sweeps": n_k}}


@pytest.mark.parametrize("cell,small", [
    (CELL, _small(64, 4, 61)), (CELL, _small(100, 3, 61)),
    (CELL, _small(48, 8, 125)), (SMOOTHER, _smoother(16, 3)),
    (SMOOTHER, _smoother(10, 2))])
def test_reference_agrees_with_the_port_on_the_cpu(cell, small):
    limits = run.spec.workload(run.spec.benchmark(), cell)["file"]["limits"]
    got = control.reading(cell, 1000 + len(str(small)), False, "cpu", small)
    for name, limit in limits.items():
        assert math.isfinite(got[name]) and got[name] <= limit, (name, got)


def _broken_run(monkeypatch, target, replacement, cell=CELL, small=SMALL):
    monkeypatch.setattr(target[0], target[1], replacement)
    return run.run(cell, 77, 0.1, False, device="cpu", overrides=small)


def test_a_step_that_leaves_the_map_unchanged_is_not_correct(monkeypatch):
    import rbslam_tpu_torch.engines.rbpf as rbpf

    update = rbpf.kf_update_lowrank

    def unchanged(bidx, C, xl_gathered, Wt_gathered, *args, **kw):
        xl, wnew, logw, bad = update(bidx, C, xl_gathered, Wt_gathered,
                                     *args, **kw)
        return xl_gathered, torch.zeros_like(wnew), logw, bad

    r = _broken_run(monkeypatch, (rbpf, "kf_update_lowrank"), unchanged)
    assert r["correct"] is False
    assert r["checks"]["map_err"]["value"] > r["checks"]["map_err"]["limit"]


@pytest.mark.parametrize("cell,small", [(CELL, SMALL),
                                        (SMOOTHER, SMALL_SMOOTHER)])
def test_weights_normalized_over_half_the_particles_are_not_correct(
        monkeypatch, cell, small):
    import rbslam_tpu_torch.engines.rbpf as rbpf

    def half(self, logw):
        h = logw.shape[0] // 2
        logz = torch.logsumexp(logw[:h], -1) + math.log(2.0)
        logw_n = logw - logz
        return torch.exp(logw_n), logw_n, logz, logw_n

    r = _broken_run(monkeypatch, (rbpf.Ensemble, "normalize"), half, cell,
                    small)
    assert r["correct"] is False


def test_a_smoother_step_that_leaves_the_map_unchanged_is_not_correct(
        monkeypatch):
    import rbslam_tpu_torch.engines.rbps_info as info

    update = info._kf_info_update_batched

    def unchanged(C, P, xl, *args, **kw):
        out = update(C, P, xl, *args, **kw)
        return (xl, P) + out[2:]

    r = _broken_run(monkeypatch, (info, "_kf_info_update_batched"),
                    unchanged, SMOOTHER, SMALL_SMOOTHER)
    assert r["correct"] is False
    assert r["checks"]["map_err"]["value"] > r["checks"]["map_err"]["limit"]


@pytest.mark.parametrize("particle", [0, 7])
def test_an_altered_smoother_draw_is_not_correct(monkeypatch, particle):
    """One particle's resampling draw in every sweep moved by half the
    ensemble. (The reference particle's ancestor draw and the kept index
    have no limit: no lower precision separates them from sound runs.)"""
    import rbslam_tpu_torch.engines.rbpf as rbpf

    resample = rbpf.Ensemble.resample

    def altered(self, u, w, scheme):
        ai, restart = resample(self, u, w, scheme)
        ai = ai.clone()
        ai[particle] = (ai[particle] + self.n // 2) % self.n
        return ai, restart

    r = _broken_run(monkeypatch, (rbpf.Ensemble, "resample"), altered,
                    SMOOTHER, SMALL_SMOOTHER)
    assert r["correct"] is False
    assert r["checks"]["anc_gap"]["value"] > r["checks"]["anc_gap"]["limit"]


def test_an_altered_ancestor_is_not_correct(monkeypatch):
    import rbslam_tpu_torch.engines.rbpf as rbpf

    resample = rbpf.Ensemble.resample

    def altered(self, u, w, scheme):
        ai, restart = resample(self, u, w, scheme)
        ai = ai.clone()
        ai[0] = (ai[0] + self.n // 2) % self.n
        return ai, restart

    r = _broken_run(monkeypatch, (rbpf.Ensemble, "resample"), altered)
    assert r["correct"] is False
    assert r["checks"]["anc_gap"]["value"] > r["checks"]["anc_gap"]["limit"]


def test_a_call_that_raises_is_counted_failed_and_not_correct(monkeypatch):
    calls = []

    def flaky(self, noise):
        calls.append(1)
        if len(calls) == 2:          # the window's first call
            raise RuntimeError("lost")
        return original(self, noise)

    from benchmark.engines.run_rbpf import Cell
    original = Cell.call
    monkeypatch.setattr(Cell, "call", flaky)
    r = run.run(CELL, 78, 0.1, False, device="cpu", overrides=SMALL)
    assert r["failed"] >= 1 and r["correct"] is False


def _card_small(cell):
    if cell == CELL:
        small = _small(1024, 8, 125)
        small["config"]["data"] = {"n_laps": 3, "n_per_lap": 64}
        return small
    small = _smoother(100, 3)
    small["config"] = {"data": {"n_laps": 1, "n_per_lap": 64}}
    return small


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [CELL, SMOOTHER])
def test_the_control_reads_above_the_program_on_the_card(cuda_device, cell):
    """The control (the filter with TF32 matmuls on; the smoother's
    reference run free with TF32 matmuls and float32 ancestor weights)
    against the program as configured, at a size a test run holds; on the
    chip at the cell's own size: ``python3 benchmark/control.py``."""
    small = _card_small(cell)
    limits = run.spec.workload(run.spec.benchmark(), cell)["file"]["limits"]
    for seed in (1, 2, 3):
        sound = control.reading(cell, seed, False, cuda_device, small)
        ctl = control.reading(cell, seed, True, cuda_device, small)
        assert any(sound[k] > 0 and ctl[k] >= 3 * sound[k]
                   for k in limits), (sound, ctl)
