"""The program's spans in a trace (``portbench/spans.py``): device work
credited to the innermost program span by its launch's correlation, on
any thread; blocking calls counted inside program spans only; idle gaps
named by the innermost span of either kind; the phases' sums. On small
synthetic traces, and on a tiny traced run on the CPU."""

from __future__ import annotations

import time

import pytest

from portbench import spans, spec, trace
from portbench.run import run_cell


def _x(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts * 1e3, "dur": dur * 1e3, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _events():
    """Two items in a window of 20 ms. Item 0 (a step, [0, 10]): the
    generator's forward [1, 3] launches a conv [1.5, 3.5] and its loss
    [3, 4] a reduction [4, 5]; the backward [4, 7] on the main thread, a
    kernel [5.5, 6.5] launched at 5 from autograd's thread (tid 2); the
    optimizer [7, 8.8] launches a copy [8, 9] and waits for it
    (``cudaStreamSynchronize``). Item 1: the step spans to 11.95, a kernel
    [11, 12] whose launch is not in the trace, ``portbench.sync`` [11.95,
    20] holding a ``cudaDeviceSynchronize``."""
    return [
        _x("user_annotation", "portbench.window", 0, 20),
        _x("user_annotation", "portbench.step", 0, 10),
        _x("user_annotation", "bssfp.step", 0.5, 9),
        _x("user_annotation", "bssfp.gen.forward", 1, 2),
        _x("user_annotation", "bssfp.gen.loss", 3, 1),
        _x("user_annotation", "bssfp.gen.backward", 4, 3),
        _x("user_annotation", "bssfp.gen.optimizer", 7, 1.8),
        _x("cuda_runtime", "cudaLaunchKernel", 1.2, 0.01, corr=1),
        _x("kernel", "void conv3x3_wgmma_kernel<32>", 1.5, 2, corr=1),
        _x("cuda_driver", "cuLaunchKernel", 3.5, 0.01, corr=2),
        _x("kernel", "void at::native::reduce_kernel<512, 1>", 4, 1, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 5, 0.01, tid=2, corr=3),
        _x("kernel", "void at::native::vectorized_elementwise_kernel<4>", 5.5, 1, corr=3),
        _x("cuda_runtime", "cudaMemcpyAsync", 7.5, 0.01, corr=4),
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 8, 1, corr=4),
        _x("cuda_runtime", "cudaStreamSynchronize", 7.6, 1.1),
        _x("user_annotation", "portbench.step", 10, 1.95),
        _x("user_annotation", "bssfp.step", 10.05, 1.85),
        _x("kernel", "sm90_xmma_fprop_implicit_gemm", 11, 1, corr=99),
        _x("user_annotation", "portbench.sync", 11.95, 8.05),
        _x("cuda_runtime", "cudaDeviceSynchronize", 12.1, 7.8),
        _x("kernel", "outside the window", 21, 1, corr=5),
        _x("cuda_runtime", "cudaLaunchKernel", 19, 0.01, corr=5),
    ]


def test_device_work_goes_to_the_innermost_span_of_its_launch():
    t = spans.attribute(_events(), items=2)
    rows = t["spans"]
    # the conv runs past its forward span's end: its launch at 1.2 ms decides
    assert rows["bssfp.gen.forward"]["device_s"] == pytest.approx(0.002 / 2)
    # a driver launch at 3.5 ms, in the loss span, though the kernel runs in the backward's
    assert rows["bssfp.gen.loss"]["device_s"] == pytest.approx(0.001 / 2)
    assert rows["bssfp.gen.optimizer"]["ops"] == pytest.approx(0.5)
    assert rows["bssfp.step"]["device_s"] == 0.0  # every launch lies in an inner span
    assert t["device_s"] == pytest.approx(0.006 / 2)


def test_a_launch_from_autograds_thread_goes_to_the_backward():
    rows = spans.attribute(_events(), items=2)["spans"]
    assert rows["bssfp.gen.backward"]["device_s"] == pytest.approx(0.001 / 2)
    assert rows["bssfp.gen.backward"]["ops"] == pytest.approx(0.5)


def test_a_kernel_without_its_launch_is_uncredited():
    t = spans.attribute(_events(), items=2)
    assert t["uncredited_s"] == pytest.approx(0.001 / 2)
    credited = sum(r["device_s"] for r in t["spans"].values())
    assert credited + t["uncredited_s"] == pytest.approx(t["device_s"])


def test_blocking_calls_count_inside_program_spans_only():
    t = spans.attribute(_events(), items=2)
    assert t["spans"]["bssfp.gen.optimizer"]["blocking"] == pytest.approx(0.5)
    # the cudaDeviceSynchronize in portbench.sync is no program span's
    assert spans.syncs(t) == pytest.approx(0.5)
    assert set(spans.BLOCKING) >= {"cudaDeviceSynchronize", "cudaStreamSynchronize"}


def test_host_time_of_each_span_an_item():
    rows = spans.attribute(_events(), items=2)["spans"]
    assert rows["bssfp.step"]["host_s"] == pytest.approx((0.009 + 0.00185) / 2)
    assert rows["bssfp.gen.backward"]["host_s"] == pytest.approx(0.003 / 2)


def test_idle_gaps_take_the_innermost_span_of_either_kind():
    gaps = trace.summarise(_events(), 2)["idle_gaps"]
    # busy [1.5, 3.5], [4, 5], [5.5, 6.5], [8, 9], [11, 12]
    want = {("step", 0.0015), ("bssfp.gen.loss", 0.0005), ("bssfp.gen.backward", 0.0005),
            ("bssfp.gen.backward", 0.0015), ("bssfp.step", 0.002), ("sync", 0.008)}
    got = {(k, round(v, 7)) for k, v in gaps}
    assert got == {(k, round(v, 7)) for k, v in want}
    assert gaps[0] == ["sync", pytest.approx(0.008)]


def test_phase_sums_and_coverage():
    t = spans.attribute(_events(), items=2)
    assert spans.phase_ms(t, "forward") == pytest.approx(1.0)
    assert spans.phase_ms(t, "backward") == pytest.approx(0.5)
    r = spans.report(t, "train")
    assert (r["forward_ms"], r["loss_ms"], r["backward_ms"], r["optimizer_ms"]) == \
        pytest.approx((1.0, 0.5, 0.5, 0.5))
    assert r["coverage"] == pytest.approx(5 / 6)
    assert r["syncs"] == pytest.approx(0.5) and r["uncredited_ms"] == pytest.approx(0.5)
    serve = spans.report(t, "serve")
    assert serve["predict_ms"] == 0.0 and serve["coverage"] == 0.0
    assert spans.phase_names(t, "serve") == list(spans.SERVE_SPANS)
    assert set(spans.phase_names(t, "train")) == {
        "bssfp.gen.forward", "bssfp.gen.loss", "bssfp.gen.backward", "bssfp.gen.optimizer"}


def test_a_trace_without_a_window_reads_nothing():
    events = [e for e in _events() if e["name"] != trace.WINDOW]
    assert spans.attribute(events, 2) is None
    assert trace.summarise(events, 2) is None


@pytest.mark.parametrize("workload,names", [
    ("gan-train-b16", {"bssfp.step", "bssfp.gen.forward", "bssfp.disc.optimizer"}),
    ("gan-serve-cohort-b32", set(spans.SERVE_SPANS)),
])
def test_a_tiny_traced_run_holds_the_program_spans(bench, tiny, monkeypatch, workload, names):
    """On the CPU the trace has no device work, but the window holds the
    program's spans, each item's."""
    cell, cfg, traffic = tiny(workload)
    kept = []
    load = trace.load
    monkeypatch.setattr(trace, "load", lambda path: kept.append(load(path)) or kept[-1])
    out = run_cell(bench, cell, 20260101, 0.2, True, "cpu", time.perf_counter(),
                   cfg=cfg, traffic=traffic)
    assert out["correct"]
    t = spans.attribute(kept[-1], traffic["trace_items"])
    assert names <= set(t["spans"])
    assert all(r["device_s"] == 0.0 and r["host_s"] > 0 for r in t["spans"].values())
    assert t["device_s"] == 0.0 and spans.coverage(t, list(names)) is None


@pytest.mark.parametrize("workload,names", [
    ("gan-train-b16", {"bssfp.step", "bssfp.gen.forward", "bssfp.disc.optimizer"}),
    ("gan-serve-cohort-b32", set(spans.SERVE_SPANS)),
])
def test_a_tiny_traced_run_gives_the_readers_spans_and_launches(bench, tiny, monkeypatch,
                                                               workload, names):
    """A traced run hands the readers the program's span table and its
    launch counters an item (all 0 on the CPU, where the plain paths run);
    an untraced one None for both."""
    cell, cfg, traffic = tiny(workload)
    seen = []

    class Capture:
        @staticmethod
        def read(ctx):
            seen.append(ctx)

    monkeypatch.setattr(spec, "reader", lambda name: Capture)
    for traced in (True, False):
        seen.clear()
        run_cell(bench, cell, 20260102, 0.2, traced, "cpu", time.perf_counter(), cfg=cfg,
                 traffic=traffic)
        ctx = seen[0]
        if traced:
            assert names <= set(ctx["spans"]["spans"])
            assert ctx["spans"]["items"] == traffic["trace_items"]
            assert {"packed_norm_act", "packed_norm_act_backward"} <= set(ctx["launches"])
            assert not any(ctx["launches"].values())
        else:
            assert ctx["spans"] is None and ctx["launches"] is None
        assert ctx["cfg"] is cfg and ctx["traffic"] is traffic
        assert set(ctx["work"]) == {"norm_act"} and ctx["peak_bandwidth"] is None
