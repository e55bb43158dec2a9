"""The trace's reduction on a synthetic trace: the union of busy intervals,
a layer's device time by the launches inside its ranges, the idle gaps by
the host's op."""
import pytest

from portbench.harness import trace


def test_union_is_not_the_sum():
    assert trace.union_length([(0, 10), (5, 15), (20, 25)]) == 20
    assert trace.union_length([(0, 10), (2, 3)]) == 10
    assert trace.union_length([]) == 0


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_read_trace():
    events = [
        _ev("user_annotation", "portbench.attn", 0, 10),
        _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, corr=1),
        _ev("cpu_op", "aten::linear", 12, 30),
        _ev("cuda_runtime", "cudaLaunchKernel", 14, 1, corr=2),
        _ev("kernel", "attn_fwd", 20, 50, tid=7, corr=1),
        _ev("kernel", "gemm", 60, 40, tid=7, corr=2),  # overlaps the first: the union is 20..100
        _ev("kernel", "gemm", 150, 50, tid=7, corr=3),
    ]
    r = trace.read_trace(events)
    assert r["busy_s"] == pytest.approx(130e-6)
    assert r["span_s"] == {"attn": pytest.approx(50e-6)}
    assert r["unplaced_device_events"] == 1  # correlation 3 has no launch record
    assert r["device_ops"][0] == ["gemm", pytest.approx(90e-6)]
    assert r["idle_gaps"] == [["host: no op recorded", pytest.approx(50e-6)]]


def test_spans_wrap_what_the_readers_declare():
    import sys
    import types

    target = types.ModuleType("portbench_tests_target")
    target.work = lambda n: n * 2
    reader = types.SimpleNamespace(LAYER="demo", WRAPS=[("portbench_tests_target", "work", lambda n: 1e-3 * n)])
    sys.modules["portbench_tests_target"] = target
    try:
        orig = target.work
        with trace.Spans([reader, reader]) as spans:
            assert target.work(3) == 6 and target.work is not orig
        assert target.work is orig
        assert spans.calls == {"demo": 1} and spans.bound["demo"] == pytest.approx(3e-3)
    finally:
        del sys.modules["portbench_tests_target"]
