"""Roofline, mfu and idle arithmetic on synthetic traces."""

import pytest

from perfbench.counts.emformer import emformer_bytes, stack_flops, stack_geometry
from perfbench.counts.model import chunk_flops
from perfbench.counts.peaks import BF16_FLOPS, HBM_BYTES, bound_s
from perfbench.counts.topk import beam_step, launch_bytes
from perfbench.harness import RunRecord, load_json, HERE
from perfbench.run import load_reader
from perfbench.trace import base_name, summarize

VI = load_json(f"{HERE}/configs/vi-ctc-emformer20.json")
EN = load_json(f"{HERE}/configs/en-rnnt-emformer-base.json")


def kernel(name, ts, dur):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}


def span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": "bench." + name,
            "ts": ts, "dur": dur}


def test_base_names():
    assert base_name("void gemm_bf16_wgmma_kernel<128, 2>(Params)") == \
        "gemm_bf16_wgmma"
    assert base_name("void attn_core::attention_kernel<1, 8>(Plan)") == \
        "attention"
    assert base_name("(anonymous namespace)::rows_first_kernel(float*)") == \
        "rows_first"
    assert base_name("void at::native::vectorized_elementwise_kernel<4>(x)") \
        == "vectorized_elementwise"


def test_busy_idle_and_gap_names():
    ev = [kernel("a_kernel", 0, 100), kernel("b_kernel", 50, 100),
          kernel("c_kernel", 400, 100), kernel("a_kernel", 1000, 100),
          span("tick", 0, 600), span("scatter", 200, 150)]
    t = summarize(ev, window_s=0.002, counted={})
    assert t.busy_s == pytest.approx(350e-6)
    assert t.kernels["a"] == [2, pytest.approx(200e-6)]
    # the longest gap (500-1000) has no span; the next (150-400) is in
    # scatter, inside tick
    assert t.gaps[0] == (pytest.approx(500e-6), "outside tick")
    assert t.gaps[1] == (pytest.approx(250e-6), "scatter")
    run = RunRecord("c", "closed", VI, 256, 0.64, trace=t)
    idle = load_reader("device_idle_pct.sat").read(run)
    assert idle == pytest.approx(100 * (1 - 350e-6 / 0.002))
    assert load_reader("device_idle_pct.paced").read(run) is None


def _a_trace(step_s, steps, drop=0):
    """A trace of ``steps`` group steps of A (one GEMM, one attention and
    one row launch a step), ``drop`` GEMM records lost."""
    ev, ts = [], 0.0
    for i in range(steps):
        for name, frac in (("gemm_bf16_wgmma_kernel<1>", 0.6),
                           ("attention_kernel<2>", 0.3),
                           ("rows_first_kernel", 0.1)):
            if not (name.startswith("gemm") and i < drop):
                ev.append(kernel(name, ts, step_s * frac * 1e6))
            ts += step_s * frac * 1e6
        ev.append(kernel("other_kernel", ts, 100.0))
        ts += 100.0
    counted = {"call.emformer_stack": steps, "kernel.gemm_bf16": steps,
               "kernel.attention": steps, "kernel.rows_first": steps}
    return summarize(ev, window_s=ts * 1e-6 * 1.5, counted=counted)


def test_kernel_a_roofline_and_step_time():
    t = _a_trace(2.9e-3, 10)
    run = RunRecord("c", "closed", VI, 256, 0.64, trace=t)
    geo = stack_geometry(VI["emformer"], 256)
    bound = bound_s(stack_flops(*geo), emformer_bytes(*geo))
    assert bound == pytest.approx(1.382e-3 / 2, rel=0.01)   # ops-bound
    got = load_reader("kernel_a_roofline_pct").read(run)
    assert got == pytest.approx(100 * bound / 2.9e-3)
    step = load_reader("step_device_ms.sat").read(run)
    assert step == pytest.approx(2.9 + 0.1)


def test_dropped_records_are_scaled_not_read_high():
    full = _a_trace(2.9e-3, 10)
    dropped = _a_trace(2.9e-3, 10, drop=3)
    ra = RunRecord("c", "closed", VI, 256, 0.64, trace=full)
    rb = RunRecord("c", "closed", VI, 256, 0.64, trace=dropped)
    a = load_reader("kernel_a_roofline_pct").read(ra)
    b = load_reader("kernel_a_roofline_pct").read(rb)
    assert b == pytest.approx(a)
    # every record of a counted kernel gone: no reading at all
    gone = _a_trace(2.9e-3, 4, drop=4)
    rc = RunRecord("c", "closed", VI, 256, 0.64, trace=gone)
    assert load_reader("kernel_a_roofline_pct").read(rc) is None


def test_kernel_e_roofline():
    per_step, step_bytes = beam_step(256, 10, 4097, 4, 4)
    assert per_step == 36
    assert step_bytes == 4 * (4 * (launch_bytes(2560, 4097, 10)
                                   + launch_bytes(256, 100, 10))
                              + launch_bytes(256, 50, 10))
    ev = [kernel("row_topk_wide_kernel", i * 100.0, 50.0) for i in range(72)]
    t = summarize(ev, window_s=0.01, counted={"call.row_topk": 72})
    run = RunRecord("c", "closed", EN, 256, 0.16, trace=t)
    got = load_reader("kernel_e_roofline_pct").read(run)
    assert got == pytest.approx(100 * 2 * step_bytes / HBM_BYTES / 3.6e-3)
    assert load_reader("kernel_e_roofline_pct").read(
        RunRecord("c", "closed", VI, 256, 0.64, trace=t)) is None


def test_mfu():
    run = RunRecord("c", "closed", VI, 256, 0.64, window_s=10.0,
                    chunks=100_000)
    per = chunk_flops(VI)
    assert 2.6e9 < per < 3.0e9                # about 2.8 GFLOP a chunk
    got = load_reader("mfu_pct").read(run)
    assert got == pytest.approx(100 * 100_000 * per / (10.0 * BF16_FLOPS))
    en = chunk_flops(EN)
    assert 3e9 < en < 6e9
