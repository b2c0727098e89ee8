"""The one traffic generator: a traffic mix is a data file of parameters.

``perfbench/traffic/<name>.json`` holds a mix's parameters; this module
reads it and, from ``--seed``, makes what a run offers:

* an audio pool shared by every stream: voiced stretches of seeded
  Gaussian noise (``voiced_s`` long, ``amplitude`` times N(0, 1), clipped
  to [-1, 1]) between digital silences (``silence_s`` long), so that the
  energy gate and the endpointer see both.  A stream reads the pool
  cyclically from an offset of its own;
* for ``"loop": "closed"``, ``streams`` backlogged streams, each kept
  ``backlog`` chunks ahead of its harvests for the whole window, then
  drained for at most ``drain_s``;
* for ``"loop": "open"``, ``streams`` concurrent paced streams: each sends
  one segment every segment period, the streams' phases spread evenly
  over the period; lifetimes are log-normal (``life_s``) and clipped, the
  first stream of each seat pre-aged (a uniform share of its lifetime
  already gone), and a seat admits a new stream one period after its
  stream ends, so that the window sees steady churn.

Durations, lifetimes and offsets come from stratified sets permuted by
the seed, so every seed offers the same amount of work in another order.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
from typing import List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_mix(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def stratified(rng, n: int, lo: float, hi: float) -> np.ndarray:
    """n values evenly spread over [lo, hi], in an order from ``rng``."""
    return rng.permutation(lo + (hi - lo) * (np.arange(n) + 0.5) / n)


def lognormal_set(rng, n: int, median: float, sigma: float, lo: float,
                  hi: float) -> np.ndarray:
    """n stratified quantiles of a clipped log-normal, permuted."""
    z = [statistics.NormalDist().inv_cdf((k + 0.5) / n) for k in range(n)]
    return rng.permutation(np.clip(median * np.exp(sigma * np.asarray(z)),
                                   lo, hi))


def audio_pool(rng, mix: dict, sample_rate: int) -> np.ndarray:
    """The pool: alternating voiced stretches and silences, float32."""
    total = int(mix["pool_s"] * sample_rate)
    n = max(4, int(mix["pool_s"] / (np.mean(mix["voiced_s"])
                                    + np.mean(mix["silence_s"]))) + 2)
    voiced = stratified(rng, n, *mix["voiced_s"])
    silence = stratified(rng, n, *mix["silence_s"])
    amp = stratified(rng, n, *mix["amplitude"])
    noise = rng.standard_normal(total).astype(np.float32)
    pool = np.zeros(total, np.float32)
    pos = 0
    for v, s, a in zip(voiced, silence, amp):
        end = min(total, pos + int(v * sample_rate))
        pool[pos:end] = np.clip(noise[pos:end] * a, -1.0, 1.0)
        pos = end + int(s * sample_rate)
        if pos >= total:
            break
    return pool


@dataclasses.dataclass
class PacedStream:
    """One paced stream: its seat, first due time (seconds from the
    traffic's start), number of chunks and pool offset."""
    seat: int
    start: float
    n_chunks: int
    offset: int
    index: int = 0          # the stream's number, in order of start


@dataclasses.dataclass
class Traffic:
    mix: dict
    pool: np.ndarray
    segment: int             # samples a chunk adds
    period: float            # seconds of audio a chunk carries
    offsets: np.ndarray      # closed loop: each stream's pool offset
    paced: List[PacedStream]

    def chunk(self, offset: int, k: int) -> np.ndarray:
        """Chunk k (new audio) of a stream reading the pool at ``offset``."""
        n = len(self.pool)
        a = (offset + k * self.segment) % n
        if a + self.segment <= n:
            return self.pool[a:a + self.segment]
        return np.concatenate([self.pool[a:], self.pool[:a + self.segment - n]])


def make_traffic(mix: dict, seed: int, sample_rate: int, segment: int,
                 horizon_s: float) -> Traffic:
    """What a run offers, from the mix and the seed.  ``horizon_s``: how
    long the open loop must run (warm-up, window and drain)."""
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
    pool = audio_pool(rng, mix, sample_rate)
    period = segment / sample_rate
    n = int(mix["streams"])
    offsets = (stratified(rng, n, 0, len(pool)).astype(np.int64)
               // segment) * segment
    paced: List[PacedStream] = []
    if mix["loop"] == "open":
        life = mix["life_s"]
        # enough lifetimes for every seat's successors over the horizon
        per_seat = int(horizon_s / life["min"]) + 2
        lives = lognormal_set(rng, n * per_seat, life["median"],
                              life["sigma"], life["min"], life["max"])
        aged = stratified(rng, n, 0.0, 1.0)
        starts = stratified(rng, n * per_seat, 0, len(pool))
        j = 0
        for seat in range(n):
            t = seat / n * period          # the seat's phase
            first = True
            while t < horizon_s:
                life_s = lives[j] * (aged[seat] if first else 1.0)
                chunks = max(1, int(round(life_s / period)))
                paced.append(PacedStream(
                    seat, t, chunks,
                    int(starts[j] // segment) * segment))
                j += 1
                t += (chunks + 1) * period
                first = False
        paced.sort(key=lambda p: p.start)
        for i, p in enumerate(paced):
            p.index = i
    return Traffic(mix, pool, segment, period, offsets, paced)
