"""The port's GroupedScheduler and pipelined Scheduler vs the JAX
package's, in process and through the pipelined device worker.

The JAX GroupedScheduler runs with its synchronous harvest
(ASR_NO_ASYNC_HARVEST=1), the oracle for event order (ROADMAP fault 2),
on the overfit fixture's weights.  Which group ticks next depends on
which pack is on the host first, so groups compare stream by stream: each
stream's own sequence of events must be equal.
"""

import numpy as np
import pytest

import jax

from asr_streaming_tpu.models.asr import ASRConfig as JASRConfig
from asr_streaming_tpu.models.serving import (
    ServingConfig as JServingConfig, init_serving_params as j_init_params,
)
from asr_streaming_tpu.streaming.endpoint import EndpointRule as JEndpointRule
from asr_streaming_tpu.streaming.scheduler import (
    GroupedScheduler as JGroupedScheduler,
)
from asr_streaming_tpu_torch.streaming.scheduler import (
    GroupedScheduler, Scheduler,
)
from asr_streaming_tpu_torch.utils.checkpoint import load_params
from tests.test_torch_device_worker import WORKER, fixture_setup, run_streams
from tests.test_torch_asr import FIXTURE
from tests.test_torch_scheduler import TONE_VOCAB, TRAINED_RULE


def per_stream(events):
    out = {}
    for sid, kind, text in events:
        out.setdefault(sid, []).append((kind, text))
    return out


@pytest.fixture
def sync_harvest(monkeypatch):
    monkeypatch.setenv("ASR_NO_ASYNC_HARVEST", "1")


def test_grouped_matches_jax_grouped_sync_harvest(sync_harvest):
    golden, cfg, params, rules, audio = fixture_setup()
    jcfg = JServingConfig(asr=JASRConfig.tiny(vocab_size=len(TONE_VOCAB)),
                          use_silero=False, use_energy_gate=False,
                          energy_threshold_db=-200.0)
    jparams = j_init_params(jax.random.PRNGKey(1), jcfg)
    trained = load_params(FIXTURE)
    jparams["frontend"] = trained["frontend"]
    jparams["encoder"] = trained["encoder"]
    jsched = JGroupedScheduler(jparams, jcfg, TONE_VOCAB, max_slots=4,
                               groups=2,
                               rules={"r": JEndpointRule(**TRAINED_RULE)})
    want, _ = run_streams(jsched, audio)
    jsched.close()
    sched = GroupedScheduler(params, cfg, TONE_VOCAB, max_slots=4, groups=2,
                             rules=rules, device="cpu")
    got, _ = run_streams(sched, audio)
    sched.close()
    assert golden in [text for _, kind, text in want if kind == "final"]
    assert per_stream(got) == per_stream(want)


def test_grouped_worker_matches_grouped_in_process():
    golden, cfg, params, rules, audio = fixture_setup("mulaw")
    ref = GroupedScheduler(params, cfg, TONE_VOCAB, max_slots=4, groups=2,
                           rules=rules, device="cpu")
    want, want_em = run_streams(ref, audio)
    ref.close()
    wk = GroupedScheduler(None, cfg, TONE_VOCAB, max_slots=4, groups=2,
                          rules=rules, device_worker=WORKER)
    try:
        assert wk.warmup() > 0          # the first view warms, others skip
        got, got_em = run_streams(wk, audio)
        stats = wk.client.stats()
    finally:
        wk.close()
    assert per_stream(got) == per_stream(want)
    assert golden in [text for _, kind, text in got if kind == "final"]
    for sid, rows in want_em.items():
        for g, w in zip(got_em[sid], rows):
            np.testing.assert_array_equal(g, w)
    assert not any(stats["launches"].values())


def test_async_harvest_equals_sync(monkeypatch):
    """The port's own async == sync test: the harvest thread changes when
    a pack is waited for, never the events or their order."""
    _, cfg, params, rules, audio = fixture_setup()
    runs = []
    for async_on in (False, True):
        if async_on:
            monkeypatch.delenv("ASR_NO_ASYNC_HARVEST", raising=False)
        else:
            monkeypatch.setenv("ASR_NO_ASYNC_HARVEST", "1")
        sched = Scheduler(params, cfg, TONE_VOCAB, max_slots=4, rules=rules,
                          device="cpu")
        assert sched._async_harvest is async_on
        runs.append(run_streams(sched, audio)[0])
        sched.close()
    assert runs[0] == runs[1]


def test_pipeline_depth_two_keeps_each_streams_events():
    _, cfg, params, rules, audio = fixture_setup()
    base = Scheduler(params, cfg, TONE_VOCAB, max_slots=4, rules=rules,
                     device="cpu")
    deep = Scheduler(params, cfg, TONE_VOCAB, max_slots=4, rules=rules,
                     device="cpu", pipeline_depth=2)
    want, _ = run_streams(base, audio)
    got, _ = run_streams(deep, audio)
    assert per_stream(got) == per_stream(want)


def test_events_surface_one_tick_after_their_gather(sync_harvest):
    golden, cfg, params, rules, audio = fixture_setup()
    sched = Scheduler(params, cfg, TONE_VOCAB, max_slots=2, rules=rules,
                      device="cpu")
    s = sched.admit("a")
    s.accept_waveform(audio[0])
    assert sched.tick() == []                 # gathered and dispatched
    assert sched.is_pending(s) and sched.harvest_ready()
    sched.tick()                              # harvests the first chunk
    assert sched.timers.snapshot()["counters"]["chunks_processed"] == 1
