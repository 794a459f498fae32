"""The port's command line (``python -m rbslam_tpu_torch``) against the JAX
package's, and its profiling helpers (utils/profiling.py), on the CPU."""

import glob
import json
import os

import pytest

torch = pytest.importorskip("torch")

from rbslam_tpu import __main__ as jmain  # noqa: E402
from rbslam_tpu_torch import __main__ as tmain  # noqa: E402
from rbslam_tpu_torch.utils import (  # noqa: E402
    phase_annotation,
    trace_to,
)


def test_workload_names_match_jax():
    assert set(tmain._WORKLOADS) == set(jmain._WORKLOADS)
    for name, module in tmain._WORKLOADS.items():
        assert module == jmain._WORKLOADS[name].replace(
            "rbslam_tpu.", "rbslam_tpu_torch.")


@pytest.mark.parametrize("argv,code", [([], 2), (["--help"], 0), (["-h"], 0),
                                       (["no-such-workload"], 2)])
def test_usage_and_unknown_names(argv, code, capsys):
    """The JAX CLI's exit codes: usage with --help exits 0, without any
    argument 2; an unknown name exits 2 and lists the options."""
    with pytest.raises(SystemExit) as exc:
        tmain.main(argv)
    assert exc.value.code == code
    out = capsys.readouterr().out
    for name in tmain._WORKLOADS:
        assert name in out
    if argv == ["no-such-workload"]:
        assert "unknown workload 'no-such-workload'" in out


def test_dispatches_to_the_workload(capsys):
    tmain.main(["dense-radio", "--quick", "--device", "cpu"])
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["workload"] == "slam-dense-radio"
    assert report["device"] == "cpu"
    assert len(report["rmse_smoother_per_sweep"]) == 3


def test_phase_annotation_names_a_profiler_scope():
    x = torch.randn(64, 64)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with phase_annotation("rbpf_step"):
            x @ x
    assert "rbpf_step" in {e.key for e in prof.key_averages()}


def test_trace_to_writes_a_chrome_trace(tmp_path):
    x = torch.randn(32, 32)
    with trace_to(str(tmp_path)) as prof:
        with phase_annotation("rbpf_lowrank"):
            torch.linalg.cholesky(x @ x.T + torch.eye(32))
    files = glob.glob(os.path.join(tmp_path, "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "rbpf_lowrank" in names
    assert any("cholesky" in str(n) for n in names)
    assert "rbpf_lowrank" in {e.key for e in prof.key_averages()}
