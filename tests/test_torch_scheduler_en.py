"""The port's English scheduling: the RNNT overfit fixture through
``Scheduler`` and ``GroupedScheduler``, greedy and beam, in process and
over a CPU device-worker child, and against the JAX scheduler.

Everything here serves the committed trained fixture
(assets/test_fixtures/overfit_rnnt.npz, with overfit_rnnt_vad.npz gating
the beam mode as the fixture's own acceptance does): its argmaxes and beam
orders are confident, so event streams are stable under load.  The JAX
scheduler runs with its synchronous harvest (ASR_NO_ASYNC_HARVEST=1) and
waits for each step (``torch_train_common.synchronous``): the oracle for
event order.  Event texts are compared exactly.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax

from asr_streaming_tpu.models.asr import ASRConfig as JASRConfig
from asr_streaming_tpu.models.rnnt import RNNTConfig as JRNNTConfig
from asr_streaming_tpu.models.serving import (
    ServingConfig as JServingConfig, init_serving_params as j_init_params,
)
from asr_streaming_tpu.streaming.endpoint import EndpointRule as JEndpointRule
from asr_streaming_tpu.streaming.scheduler import Scheduler as JScheduler
from asr_streaming_tpu.utils.audio import EN_AUDIO as J_EN_AUDIO
from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.rnnt import (
    RNNTConfig, make_rnnt_rescorer,
)
from asr_streaming_tpu_torch.models.serving import (
    ServingConfig, init_serving_params,
)
from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
from asr_streaming_tpu_torch.streaming.scheduler import (
    GroupedScheduler, Scheduler,
)
from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, overlay_params, params_from_numpy, save_params,
)
from tests.fixture_assets import asset_path
from tests.test_overfit_rnnt_e2e import PIECES, _sentence_audio
from tests.torch_train_common import synchronous

FIXTURE = asset_path("overfit_rnnt")
VAD_FIXTURE = asset_path("overfit_rnnt_vad")
RULE = dict(must_contain_nonsilence=True, min_trailing_silence=0.8,
            min_utterance_length=0.0, max_relative_cost=float("inf"))
SERVING = dict(model_kind="rnnt", use_energy_gate=False,
               energy_threshold_db=-200.0)
# greedy serves ungated; the beam serves behind the trained VAD
MODES = {"greedy": ({}, False),
         "beam": (dict(en_beam_partials=True, en_beam_width=4), True)}


def _golden() -> str:
    with np.load(FIXTURE) as z:
        return json.loads(str(z["__meta__"]))["beam_golden"]


def _torch_setup(silero: bool):
    cfg = ServingConfig(
        asr=dataclasses.replace(ASRConfig.tiny(), audio=EN_AUDIO),
        rnnt=RNNTConfig.tiny(vocab_size=len(PIECES)), use_silero=silero,
        **SERVING)
    params = overlay_params(init_serving_params(1, cfg, "cpu"),
                            load_params(FIXTURE))
    if silero:
        params = overlay_params(params, {"vad": load_params(VAD_FIXTURE)})
    return cfg, params


def _audio(golden):
    one = _sentence_audio(golden, total=3.84)
    return [one, np.concatenate([one, one])]     # t1: final, reset, final


def _events(sched, audio):
    streams = [sched.admit(f"t{i}") for i in range(len(audio))]
    for s, a in zip(streams, audio):
        s.accept_waveform(a)
        s.add_tail_padding()
    out = {}
    for e in sched.drain():
        out.setdefault(e.stream_id, []).append((e.kind, e.text))
    return out


def _finals(events, sid):
    return [t.strip() for k, t in events[sid] if k == "final" and t.strip()]


@pytest.mark.parametrize("mode,impl_kw", [
    ("greedy", {}), ("greedy", {"pipeline_depth": 2}),
    ("beam", {"en_beam_impl": "device"}), ("beam", {"en_beam_impl": "host"})],
    ids=["greedy", "greedy-depth2", "beam-device", "beam-host"])
def test_golden_final_in_process(mode, impl_kw):
    golden = _golden()
    kw, silero = MODES[mode]
    cfg, params = _torch_setup(silero)
    sched = Scheduler(params, cfg, PIECES, max_slots=2, language="en",
                      rules={"r": EndpointRule(**RULE)}, device="cpu",
                      **kw, **impl_kw)
    assert sched.is_rnnt and sched.en_beam_partials == (mode == "beam")
    ev = _events(sched, _audio(golden))
    sched.close()
    assert _finals(ev, "t0") == [golden]
    assert _finals(ev, "t1") == [golden, golden]
    partials = [t.strip() for k, t in ev["t0"] if k == "partial"]
    assert partials and all(golden.startswith(p) for p in partials)
    for a, b in zip(partials, partials[1:]):
        assert b.startswith(a)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_events_match_the_jax_scheduler_sync_harvest(mode, monkeypatch):
    monkeypatch.setenv("ASR_NO_ASYNC_HARVEST", "1")
    golden = _golden()
    kw, silero = MODES[mode]
    jcfg = JServingConfig(
        asr=dataclasses.replace(JASRConfig.tiny(), audio=J_EN_AUDIO),
        rnnt=JRNNTConfig.tiny(vocab_size=len(PIECES)), use_silero=silero,
        **SERVING)
    jparams = j_init_params(jax.random.PRNGKey(1), jcfg)
    jparams.update(load_params(FIXTURE))
    if silero:
        jparams["vad"] = load_params(VAD_FIXTURE)

    def jax_events():
        jsched = synchronous(JScheduler(
            jparams, jcfg, PIECES, max_slots=2, language="en",
            rules={"r": JEndpointRule(**RULE)}, **kw))
        assert jsched._async_harvest is False
        try:
            return _events(jsched, _audio(golden))
        finally:
            jsched.close()

    cfg, _ = _torch_setup(silero)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    sched = Scheduler(params, cfg, PIECES, max_slots=2, language="en",
                      rules={"r": EndpointRule(**RULE)}, device="cpu", **kw)
    got = _events(sched, _audio(golden))
    sched.close()
    # the port's stream is held to the golden on its own account
    assert _finals(got, "t0") == [golden]
    assert _finals(got, "t1") == [golden, golden]

    # The JAX scheduler's EN event stream is not steady on a loaded
    # machine, even with trained weights and the sync harvest (its own
    # two-segment test fails there now and then).  An oracle run that
    # equals the port's stream settles it; oracle runs that all agree
    # with each other and not with the port are a real difference; runs
    # that disagree among themselves are no oracle.
    runs = []
    for _ in range(3):
        runs.append(jax_events())
        if runs[-1] == got:
            return
    assert any(r != runs[0] for r in runs), \
        f"port {got} != the JAX scheduler's steady {runs[0]}"
    pytest.skip("the JAX scheduler's event stream varied between identical "
                "runs and none equalled the port's")


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_worker_child_serves_the_same_events(mode, tmp_path):
    """Scheduler over a DeviceWorkerClient child and GroupedScheduler over
    the pipelined child, on the CPU: the in-process events, stream by
    stream, and no module of jax or the JAX package in the child."""
    golden = _golden()
    kw, silero = MODES[mode]
    cfg, params = _torch_setup(silero)
    rules = {"r": EndpointRule(**RULE)}
    common = dict(language="en", rules=rules, **kw)
    ref = Scheduler(params, cfg, PIECES, max_slots=2, device="cpu", **common)
    want = _events(ref, _audio(golden))
    ref.close()
    assert _finals(want, "t1") == [golden, golden]

    worker = {"seed": 1, "checkpoint": FIXTURE, "device": "cpu"}
    if silero:      # the child reads VAD weights under a "vad" subtree
        worker["vad_weights"] = str(tmp_path / "vad.npz")
        save_params(worker["vad_weights"], {"vad": load_params(VAD_FIXTURE)})
    single = Scheduler(None, cfg, PIECES, max_slots=2, device_worker=worker,
                       **common)
    try:
        single.warmup()
        got = _events(single, _audio(golden))
        stats = single.worker.stats()
    finally:
        single.close()
    assert got == want
    assert stats["foreign_modules"] == []

    grouped = GroupedScheduler(None, cfg, PIECES, max_slots=2, groups=2,
                               device_worker=worker, **common)
    try:
        grouped.warmup()
        got = _events(grouped, _audio(golden))
    finally:
        grouped.close()
    assert got == want


def test_host_beam_needs_the_device_in_process():
    cfg, params = _torch_setup(False)
    with pytest.raises(ValueError, match="in-process device access"):
        Scheduler(None, cfg, PIECES, max_slots=2, en_beam_partials=True,
                  en_beam_impl="host", worker=object())


def test_final_segment_rescores_to_the_golden():
    """Greedy partials, beam finals: the fetched float16 encodings of the
    final segment decode back to the golden through the host beam."""
    golden = _golden()
    cfg, params = _torch_setup(False)
    sched = Scheduler(params, cfg, PIECES, max_slots=2, language="en",
                      rules={"r": EndpointRule(**RULE)}, device="cpu")
    s = sched.admit("t0")
    s.accept_waveform(_sentence_audio(golden, total=3.84))
    s.add_tail_padding()
    finals = [e for e in sched.drain() if e.is_final and e.text.strip()]
    sched.close()
    seg = finals[0].segment
    assert seg.length > 0 and seg.emission.shape == (seg.length, 48)
    text = make_rnnt_rescorer(sched.params, cfg.rnnt, PIECES)(seg)
    assert text.strip() == golden
