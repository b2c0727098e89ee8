"""The port's device worker (streaming/device_worker.py): the scheduler
with the serving step in a spawned child gives the in-process port's
events, fetches the same emissions at finals, and raises the child's
errors in the parent.  The child runs on the CPU (``device="cpu"``) and
rebuilds the params from the seed and the overfit fixture, as a server
child rebuilds them from its seed and checkpoint.
"""

import numpy as np
import pytest

from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.serving import (
    ServingConfig, init_serving_params,
)
from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, overlay_params,
)
from tests.test_scheduler import silence
from tests.test_torch_asr import FIXTURE, golden_and_params, sentence_audio
from tests.test_torch_scheduler import TONE_VOCAB, TRAINED_RULE

WORKER = {"seed": 1, "checkpoint": FIXTURE, "device": "cpu"}


def fixture_setup(encoding="int16"):
    """(golden, cfg, params, rules, audio): the fixture's weights over the
    seed-1 random ones, three streams (one with two utterances)."""
    golden, _ = golden_and_params()
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(TONE_VOCAB)),
                        use_silero=False, use_energy_gate=False,
                        energy_threshold_db=-200.0, upload_encoding=encoding)
    params = overlay_params(init_serving_params(1, cfg, device="cpu"),
                            load_params(FIXTURE))
    one = sentence_audio(golden, total=3.84)
    audio = [one, np.concatenate([silence(0.64), one]),
             np.concatenate([one, one])]
    return golden, cfg, params, {"r": EndpointRule(**TRAINED_RULE)}, audio


def run_streams(sched, audio):
    """Drain the streams; (events, {stream id: [emission of each final]})."""
    streams = [sched.admit(f"s{i}") for i in range(len(audio))]
    for s, a in zip(streams, audio):
        s.accept_waveform(a)
        s.add_tail_padding()
    events = sched.drain()
    emissions = {}
    for e in events:
        if e.is_final and e.segment.length:
            emissions.setdefault(e.stream_id, []).append(e.segment.emission)
    return [(e.stream_id, e.kind, e.text) for e in events], emissions


@pytest.mark.parametrize("encoding", ["int16", "mulaw"])
def test_worker_events_and_emissions_equal_in_process(encoding):
    golden, cfg, params, rules, audio = fixture_setup(encoding)
    ref = Scheduler(params, cfg, TONE_VOCAB, max_slots=4, rules=rules,
                    device="cpu")
    want, want_em = run_streams(ref, audio)
    wk = Scheduler(None, cfg, TONE_VOCAB, max_slots=4, rules=rules,
                   device_worker=WORKER)
    try:
        assert wk.warmup() > 0
        got, got_em = run_streams(wk, audio)
        stats = wk.worker.stats()
    finally:
        wk.close()
    assert got == want
    assert golden in [text for _, kind, text in got if kind == "final"]
    assert set(got_em) == set(want_em)
    for sid, rows in want_em.items():
        for g, w in zip(got_em[sid], rows):
            np.testing.assert_array_equal(g, w)
    # on the CPU no kernel runs; the counts are there, all zero
    assert set(stats["launches"]) >= {"emformer_stack", "emission_append"}
    assert not any(stats["launches"].values())


def test_worker_error_is_raised_in_the_parent():
    _, cfg, _, rules, _ = fixture_setup()
    wk = Scheduler(None, cfg, TONE_VOCAB, max_slots=2, rules=rules,
                   device_worker=dict(WORKER, checkpoint="/nonexistent.npz"))
    try:
        with pytest.raises(RuntimeError, match="device worker error"):
            wk.worker.warmup(timeout=120)
    finally:
        wk.close()
