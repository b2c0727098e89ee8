"""Whole-window statistics, and that a stall inside the window moves the
end-to-end metrics (a median of sub-windows would hide it)."""

import statistics

import pytest

from perfbench.harness import RunRecord
from perfbench.run import load_reader
from perfbench.stats import percentile, quartile_spread, union_seconds


def _run(loop, **kw):
    model = {"kind": "ctc"}
    return RunRecord("cell", loop, model, 256, 0.64, **kw)


def test_percentile_matches_interpolation():
    xs = [5.0, 1.0, 3.0, 2.0, 4.0]
    assert percentile(xs, 50) == 3.0
    assert percentile(xs, 95) == 4.8
    assert percentile([7.0], 95) == 7.0


def test_quartile_spread_uses_statistics_quantiles():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert quartile_spread(xs) == (q3 - q1) / med


def test_union_of_intervals():
    total, merged = union_seconds([(0, 2), (1, 3), (5, 6), (6, 7), (10, 10)])
    assert total == 5
    assert merged == [(0, 3), (5, 7), (10, 10)]


def test_stall_moves_rt_streams():
    rt = load_reader("rt_streams")
    steady = _run("closed", window_s=10.0, chunks=100_000)
    # the same chunks, then a 2 s stall inside the window
    stalled = _run("closed", window_s=12.0, chunks=100_000)
    assert rt.read(steady) == 100_000 * 0.64 / 10.0
    assert rt.read(stalled) < rt.read(steady) * 0.85


@pytest.mark.parametrize("name, field", [
    ("chunk_p95_ms", "latencies_s"),
    ("chunk_p95_ms.paced", "quiet_latencies_s")])
def test_stall_moves_chunk_p95(name, field):
    p95 = load_reader(name)
    p50 = load_reader("chunk_p50_ms")
    lat = [0.05] * 1000
    # a 1 s stall delays every chunk due in it: the tail moves
    stalled = lat[:900] + [0.05 + 1.0 - i / 100 for i in range(100)]
    a = _run("open", **{"latencies_s": lat, field: lat})
    b = _run("open", **{"latencies_s": stalled, field: stalled})
    assert abs(p95.read(a) - 50.0) < 1e-9
    assert p95.read(b) > 400.0
    assert abs(p50.read(b) - 50.0) < 1e-9


def test_readers_skip_other_loops():
    assert load_reader("rt_streams").read(_run("open", latencies_s=[1.0])) \
        is None
    assert load_reader("chunk_p50_ms").read(_run("closed", window_s=1.0)) \
        is None
    assert load_reader("tick_host_ms.sat").read(_run("closed")) is None


def test_tick_and_wait_means():
    tick = load_reader("tick_host_ms.sat")
    wait = load_reader("dispatch_wait_ms.paced")
    assert tick.read(_run("closed", tick_s=[0.01, 0.03])) == 20.0
    assert abs(wait.read(_run("open", waits_s=[0.001, 0.003])) - 2.0) < 1e-12
