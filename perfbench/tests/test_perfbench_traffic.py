"""The traffic generator: deterministic from the seed, the same work for
every seed, and the open loop's churn."""

import numpy as np

from perfbench import traffic


def _mix(name, **over):
    return {**traffic.load_mix(name), **over}


def test_same_seed_same_traffic():
    mix = _mix("paced", streams=64)
    a = traffic.make_traffic(mix, 2**31 + 77, 16000, 10240, 30.0)
    b = traffic.make_traffic(mix, 2**31 + 77, 16000, 10240, 30.0)
    assert np.array_equal(a.pool, b.pool)
    assert np.array_equal(a.offsets, b.offsets)
    assert [(p.seat, p.start, p.n_chunks, p.offset) for p in a.paced] == \
        [(p.seat, p.start, p.n_chunks, p.offset) for p in b.paced]


def test_other_seed_same_amount_of_work():
    mix = _mix("sat512")
    a = traffic.make_traffic(mix, 1, 16000, 10240, 30.0)
    b = traffic.make_traffic(mix, 2**33 + 5, 16000, 10240, 30.0)
    assert not np.array_equal(a.pool, b.pool)
    # the same voiced share within a stretch's rounding
    va, vb = (np.count_nonzero(t.pool) / len(t.pool) for t in (a, b))
    assert abs(va - vb) < 0.02
    assert 0.5 < va < 0.95
    assert sorted(a.offsets % 10240) == sorted(b.offsets % 10240)


def test_pool_has_speech_and_silence():
    t = traffic.make_traffic(_mix("sat512"), 3, 16000, 10240, 10.0)
    voiced = np.abs(t.pool) > 0
    edges = np.flatnonzero(np.diff(voiced.astype(np.int8)))
    assert len(edges) > 20                    # many stretches
    assert np.abs(t.pool).max() <= 1.0


def test_chunks_read_the_pool_cyclically():
    t = traffic.make_traffic(_mix("sat512"), 4, 16000, 10240, 10.0)
    n = len(t.pool)
    off = n - 5000
    c = t.chunk(off, 0)
    assert len(c) == 10240
    assert np.array_equal(c[:5000], t.pool[-5000:])
    assert np.array_equal(c[5000:], t.pool[:5240])
    assert np.array_equal(np.concatenate([t.chunk(0, k) for k in (2, 3, 4)]),
                          t.pool[2 * 10240:5 * 10240])
    assert np.shares_memory(t.chunk(0, 2), t.pool)    # a view, not a copy


def test_open_loop_staggered_with_churn():
    mix = _mix("paced", streams=100)
    t = traffic.make_traffic(mix, 9, 16000, 10240, 40.0)
    first = [p for p in t.paced if p.start < t.period]
    assert len(first) == 100                  # one stream a seat at once
    phases = sorted(p.start for p in first)
    assert np.allclose(np.diff(phases), t.period / 100)
    later = [p for p in t.paced if p.start >= 6.0]
    assert later, "streams end and seats admit new ones"
    life = mix["life_s"]
    for p in later:
        assert life["min"] - t.period <= p.n_chunks * t.period <= \
            life["max"] + t.period
    seats = {}
    for p in sorted(t.paced, key=lambda p: p.start):
        prev = seats.get(p.seat)
        if prev is not None:
            assert p.start >= prev.start + prev.n_chunks * t.period
        seats[p.seat] = p
