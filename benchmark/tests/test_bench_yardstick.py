"""The frozen yardstick: the distinct-base rebuild and the K2 / K3 byte
counts against a brute force on hand-made ancestors, the kernel-name
families, the per-layer readers on a hand-made trace, and the reference's
resampling check against the port's systematic resampler."""

from types import SimpleNamespace

import pytest
import torch

from benchmark import roofline, spec
from benchmark.trace import Trace, breakdown, busy_us, union


def _brute_distinct(ancestors, period):
    out = []
    n = len(ancestors[0])
    for t, a in enumerate(ancestors):
        if t % period == 0:
            base = list(range(n))
        base = [base[i] for i in a]
        out.append(len(set(base)))
    return out


@pytest.mark.parametrize("period", [1, 3, 4])
def test_distinct_bases_match_a_brute_force(period):
    g = torch.Generator().manual_seed(period)
    anc = [[0, 0, 1, 3, 3, 5], [1, 1, 1, 2, 4, 5], [5, 4, 3, 2, 1, 0],
           [0, 0, 0, 0, 0, 0], [2, 2, 3, 3, 4, 4]]
    anc += torch.randint(0, 6, (6, 6), generator=g).tolist()
    got = roofline.distinct_bases(torch.tensor(anc, dtype=torch.int32),
                                  period)
    assert got == _brute_distinct(anc, period)


def test_k2_and_k3_bytes_count_each_distinct_matrix_once():
    n, nl, rows, rw, s = 6, 16, 3, 9, 4
    bidx = [0, 0, 1, 3, 3, 5]
    distinct = len(set(bidx))
    # brute force: the matrices P_base[b] of the distinct b, then C, the
    # live factor rows, bidx and CP (float32) for each particle
    read = {b: nl * nl * s for b in bidx}
    k2 = sum(read.values()) + n * (3 * nl * s + rows * nl * s + 4
                                   + 3 * nl * 4)
    assert roofline.k2_gather_cp(n, distinct, nl, rows, s).nbytes == k2
    k3 = sum(read.values()) + n * (rw * nl * s + 4 + nl * nl * s)
    assert roofline.k3_rebase(n, distinct, nl, rw, s).nbytes == k3
    assert roofline.k3_rebase(n, distinct, nl, rw, s).flops == \
        n * rw * nl * (nl + 1)


def test_a_launch_is_bound_by_the_larger_of_bytes_and_ops():
    lb = roofline.Launch(3.35e12, 1.0, 4)
    assert lb.least_s() == pytest.approx(1.0)
    lo = roofline.Launch(1.0, 67e12, 4)
    assert lo.least_s() == pytest.approx(1.0)
    assert roofline.bound_ms(3.35e9, 0.0, 2) == (pytest.approx(1.0), "bytes")


@pytest.mark.parametrize("name,fam", [
    ("void (anonymous namespace)::gather_cp_kernel<float, 3>(int)", "K2"),
    ("void gather_cp_runs_kernel<true>(float const*)", "K2"),
    ("gather_cp_direct_kernel", "K2"),
    ("void (anonymous namespace)::rebase_kernel<float, true>(int)", "K3"),
    ("rebase_wide_kernel<__nv_bfloat16>(int)", "K3"),
    ("void jac_table_kernel<float, false>(int)", "K1"),
    ("void grad_table_kernel<3>(int)", "K4"),
    ("void at::native::vectorized_gather_kernel<16, long>(char*)", None),
    ("Memcpy DtoD (Device -> Device)", None),
])
def test_kernel_names_map_to_their_families(name, fam):
    assert roofline.family(name) == fam


def _ctx(device, host=(), steps=4, untraced=10e-6, plan=None, syncs=None):
    trace = Trace(list(device), list(host), 0.0,
                  SimpleNamespace(ancestors=None))
    cell = SimpleNamespace(launches=lambda anc: plan or {})
    return SimpleNamespace(trace=trace, steps=steps, cell=cell,
                           untraced_wall_s=untraced, syncs=syncs or {})


def test_readers_on_a_hand_made_trace():
    dev = [("gather_cp_kernel<float>", 0.0, 3.0),
           ("gather_cp_kernel<float>", 4.0, 6.0),
           ("aten_add_kernel", 5.0, 8.0)]
    plan = {"K2": [roofline.Launch(3e-6 * 3.35e12, 0, 4),
                   roofline.Launch(1e-6 * 3.35e12, 0, 4)]}
    ctx = _ctx(dev, plan=plan, syncs={"a.py:1": [2, "x"], "b.py:2": [6, "y"]})

    def read(name):
        return spec.reader(name).read(ctx)

    assert read("kernels_roofline") == pytest.approx(80.0)
    assert read("torch_ops.device_ms_per_step") == pytest.approx(3e-3 / 4)
    assert read("device.idle_share") == pytest.approx(1 - 7.0 / 10.0)
    assert read("engine.device_ops_per_step") == pytest.approx(3 / 4)
    assert read("engine.syncs_per_step") == pytest.approx(2.0)
    # a launch the plan does not list: no roofline, not a wrong one
    ctx.trace.device.append(("rebase_kernel<float>", 9.0, 10.0))
    assert read("kernels_roofline") is None
    assert spec.reader("kernels_roofline").read(_ctx(dev)) is None


def test_busy_time_is_the_union_and_gaps_name_the_host():
    dev = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0),
           ("d", 10.0, 11.0)]
    host = [("aten::index", 3.5, 4.5), ("aten::sub", 6.0, 9.0),
            ("cudaLaunchKernel", 7.0, 7.5)]
    assert union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]
    tr = Trace(dev, host, 0.0, None)
    assert busy_us(tr) == pytest.approx(5.0)
    b = breakdown(tr)
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"aten::index": 2e-6, "aten::sub": 4e-6})
    assert b["device_ops"][0] == ["a", pytest.approx(2e-6)]


def test_systematic_gap_is_zero_on_the_port_resampler_and_not_on_a_swap():
    from rbslam_tpu_torch.ops.resampling import systematic_resample

    from benchmark.reference.rbpf_dense import systematic_gap

    g = torch.Generator().manual_seed(3)
    w = torch.rand(500, generator=g, dtype=torch.float64) ** 4
    w = w / w.sum()
    u0 = torch.rand((), generator=g)
    a = systematic_resample(u0.float(), w.float(), 500)
    assert systematic_gap(w, u0, a) < 0.01
    a[7] = (a[7] + 250) % 500
    assert systematic_gap(w, u0, a) > 10
