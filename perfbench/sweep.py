"""The knee search of a paced cell: the same traffic at several stream
counts, groups of ``group_size`` streams, without the check; one line a
count with the whole window's p50 and p95, those of its two halves (a
growing backlog shows as a later half slower than the first) and the
chunks not harvested by the drain deadline."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench import harness, traffic as traffic_mod
from perfbench.stats import percentile


def sweep(cell, seed: int, seconds: float, counts, device="cuda"):
    device = torch.device(device)
    group = cell.mix["group_size"]
    serving = {**cell.model["serving"], **cell.work.get("serving", {})}
    seg = cell.model["audio"]["segment_length"]
    sr = cell.model["audio"]["sample_rate"]
    params, cfg, kwargs, vocab = harness.serving_setup(
        cell.model, serving, device, seed,
        traffic_mod.make_traffic(cell.mix, seed, sr, seg, 1.0))
    for n in counts:
        mix = {**cell.mix, "streams": n}
        work = {**cell.work, "serving": {
            "max_active_connections": -(-n // group) * group,
            "scheduler_groups": -(-n // group)}}
        c = dataclasses.replace(cell, mix=mix, work=work)
        sched = harness.build_scheduler(c, params, cfg, kwargs, vocab, device)
        warm, drain = mix["warm_s"], mix["drain_s"]
        tr = traffic_mod.make_traffic(mix, seed, sr, seg,
                                      warm + seconds + drain + 1.0)
        rec = harness.Recorder()
        try:
            harness.warm_path(sched, tr)
            rec.install(sched)
            loop = harness.Loop(sched, tr, rec, np.random.default_rng(seed),
                                 0)
            origin = harness.time.perf_counter()
            loop.open_start(warm + seconds)
            loop.open_until(origin, warm + seconds + drain)
            halves = []
            for a, b in ((warm, warm + seconds / 2),
                         (warm + seconds / 2, warm + seconds),
                         (warm, warm + seconds)):
                run = harness.RunRecord(c.name, "open", c.model, 0, 0.0)
                loop.open_stats(run, a, b, warm + seconds + drain)
                lat = [x * 1e3 for x in run.latencies_s] or [float("nan")]
                halves.append((percentile(lat, 50), percentile(lat, 95),
                               run.attempted, run.failed))
        finally:
            sched.close()
        whole = halves[2]
        zombies = []
        end_s = warm + seconds + drain
        for i, st in loop.live.items():
            b, nc = loop.base[i], loop.n_chunks[i]
            fed = int((~np.isnan(loop.fed_t[b:b + nc])).sum())
            last_due = loop.start[i] + (nc - 1) * tr.period
            if fed == nc and loop.n_done[i] < nc and last_due < end_s - 3.0:
                g = st._group
                zombies.append([int(nc), int(loop.n_done[i]), round(
                    end_s - last_due, 2), bool(st.has_chunk()),
                    int(st.buffer.size), len(g._pending),
                    g.streams.get(st._slot) is st])

        yield {"streams": n, "groups": work["serving"]["scheduler_groups"],
               "refused": len(loop.refused), "live_at_end": len(loop.live),
               "zombies": len(zombies), "zombie_sample": zombies[:5],
               "longest_tick_s": loop.longest_tick,
               "lateness_max_s": float(np.nanmax(loop.fed_t - loop.due_t)),
               "p50_ms": whole[0], "p95_ms": whole[1],
               "attempted": whole[2], "failed": whole[3],
               "first_half_p50_p95": halves[0][:2],
               "second_half_p50_p95": halves[1][:2]}
        del sched
        if device.type == "cuda":
            torch.cuda.empty_cache()
