"""The port's Scheduler vs the JAX package's, and the golden transcript.

The JAX scheduler runs with its synchronous harvest
(ASR_NO_ASYNC_HARVEST=1), the oracle for event order; both get the same
weights and audio, and their (stream_id, kind, text) event streams must
be equal.  The weights are the committed overfit fixture's: with random
weights many frames are near-ties between tokens, and the JAX package's
CPU results on its 8-device test mesh vary from run to run under load
(the same cause as its own async-vs-sync scheduler test failing), so
only confident, trained argmaxes make a stable oracle.
"""

import numpy as np
import pytest
import torch

import jax

from asr_streaming_tpu.models.asr import ASRConfig as JASRConfig
from asr_streaming_tpu.models.serving import (
    ServingConfig as JServingConfig, init_serving_params as j_init_params,
)
from asr_streaming_tpu.streaming.endpoint import EndpointRule as JEndpointRule
from asr_streaming_tpu.streaming.scheduler import Scheduler as JScheduler
from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.serving import (
    ServingConfig, init_serving_params,
)
from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, params_from_numpy,
)
from tests.test_scheduler import VOCAB, silence, speechy_audio
from tests.test_torch_asr import FIXTURE, golden_and_params, sentence_audio

TONE_VOCAB = ["-", "|", "a", "b", "c", "d"]
TRAINED_RULE = dict(must_contain_nonsilence=True, min_trailing_silence=0.8,
                    min_utterance_length=0.0,
                    max_relative_cost=float("inf"))


def _events(sched, audio):
    streams = [sched.admit(f"s{i}") for i in range(len(audio))]
    for s, a in zip(streams, audio):
        s.accept_waveform(a)
        s.add_tail_padding()
    return [(e.stream_id, e.kind, e.text) for e in sched.drain()]


@pytest.mark.parametrize("encoding", ["mulaw", "int16"])
def test_event_stream_matches_jax_sync_harvest(encoding, monkeypatch):
    monkeypatch.setenv("ASR_NO_ASYNC_HARVEST", "1")
    golden, _ = golden_and_params()
    one = sentence_audio(golden, total=3.84)
    # three streams: the sentence; a leading silent chunk then the
    # sentence; the sentence twice (a final, a reset, a second final)
    audio = [one, np.concatenate([silence(0.64), one]),
             np.concatenate([one, one])]
    kw = dict(use_silero=False, use_energy_gate=False,
              energy_threshold_db=-200.0, upload_encoding=encoding)
    jcfg = JServingConfig(asr=JASRConfig.tiny(vocab_size=6), **kw)
    jparams = j_init_params(jax.random.PRNGKey(1), jcfg)
    trained = load_params(FIXTURE)
    jparams["frontend"] = trained["frontend"]
    jparams["encoder"] = trained["encoder"]
    jsched = JScheduler(jparams, jcfg, TONE_VOCAB, max_slots=4,
                        rules={"r": JEndpointRule(**TRAINED_RULE)})
    assert jsched._async_harvest is False
    want = _events(jsched, audio)
    jsched.close()

    tcfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=6), **kw)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tsched = Scheduler(tparams, tcfg, TONE_VOCAB, max_slots=4,
                       rules={"r": EndpointRule(**TRAINED_RULE)},
                       device="cpu")
    got = _events(tsched, audio)
    finals = [text for _, kind, text in want if kind == "final" and text]
    assert len(finals) >= 3 and golden in finals, want
    assert got == want


def _golden_scheduler(encoding="int16"):
    golden, loaded = golden_and_params()
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(TONE_VOCAB)),
                        use_silero=False, use_energy_gate=False,
                        energy_threshold_db=-200.0, upload_encoding=encoding)
    params = init_serving_params(1, cfg, device="cpu")
    params["frontend"] = loaded["frontend"]
    params["encoder"] = loaded["encoder"]
    rules = {"trained": EndpointRule(True, 0.8, 0.0, float("inf"))}
    return golden, Scheduler(params, cfg, TONE_VOCAB, max_slots=2,
                             rules=rules, device="cpu")


@pytest.mark.parametrize("encoding", ["int16", "mulaw"])
def test_golden_transcript_through_the_port(encoding):
    golden, sched = _golden_scheduler(encoding)
    s = sched.admit("t0")
    s.accept_waveform(sentence_audio(golden, total=3.84))
    s.add_tail_padding()
    events = sched.drain()
    finals = [e for e in events if e.kind == "final" and e.text.strip()]
    assert [f.text.strip() for f in finals] == [golden]
    partials = [e.text.strip() for e in events
                if e.kind == "partial" and e.text.strip()]
    assert partials and all(golden.startswith(p) for p in partials)
    seg = finals[0].segment
    assert seg.length > 0 and seg.emission.shape == (seg.length, 6)
    assert np.isfinite(seg.emission).all()


def test_slot_recycling_starts_clean():
    golden, sched = _golden_scheduler()
    a = sched.admit("a")
    sched.admit("b")
    assert sched.admit("c") is None
    a.accept_waveform(speechy_audio(1.3, seed=2))
    sched.drain()
    sched.release(a)
    c = sched.admit("c")
    c.accept_waveform(sentence_audio(golden, total=3.84))
    c.add_tail_padding()
    finals = [e.text.strip() for e in sched.drain()
              if e.kind == "final" and e.text.strip()]
    assert finals == [golden]
    assert sched.num_active == 2
    assert sched.timers.snapshot()["counters"]["chunks_processed"] > 0


def test_unported_options_raise_and_cuda_is_the_default():
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(VOCAB)),
                        use_silero=False)
    params = init_serving_params(0, cfg, device="cpu")
    from asr_streaming_tpu_torch.streaming.scheduler import GroupedScheduler
    # meshes are ported: exclusive with the device worker, and the slots
    # must divide over the shards
    from asr_streaming_tpu_torch.parallel.serving import make_serving_mesh
    mesh = make_serving_mesh(2, device="cpu")
    for cls in (Scheduler, GroupedScheduler):
        with pytest.raises(ValueError, match="exclusive"):
            cls(params, cfg, VOCAB, mesh=mesh,
                device_worker={"device": "cpu"})
    with pytest.raises(ValueError, match="multiple"):
        Scheduler(params, cfg, VOCAB, max_slots=3, mesh=mesh)
    # en_beam_partials is ported; on a CTC config it is ignored, as in the
    # JAX scheduler
    sched = Scheduler(params, cfg, VOCAB, device="cpu", en_beam_partials=True)
    assert not sched.en_beam_partials and not sched.is_rnnt
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Scheduler(params, cfg, VOCAB)
