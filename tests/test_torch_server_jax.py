"""The port's websocket server against the JAX package's, message for message.

The same int16 streams go through both packages' ``StreamingServer`` on
loopback ports, with the same weights (the committed overfit fixtures at
the tiny geometry) and websockets' own client.  Each connection's complete
list of messages, every partial and final JSON text and then
``__REQUEST_COMPLETED__``, must be equal as strings; only the ``id``, which
the server draws from the wall clock at connect, is masked.  Both servers
rescore the Vietnamese finals with their own lexicon+LM beam over a tiny
lexicon and unigram ARPA, so the finals carry word alignments and the
fields derived from them (``segment_start``, ``word_start``/``word_end``,
SNR and the two volumes) besides ``segment``, ``segment_length`` and
``total_length``.  ``Running.serve`` (tests/test_torch_server.py) feeds
both in lockstep, and says why.

Cases: the Vietnamese CTC fixture's three streams at 16 kHz, one stream at
8 kHz (resampled by each server), and the English RNNT fixture in
``server-en.yaml``'s beam-partials mode behind its trained VAD.  The JAX
scheduler runs with its synchronous harvest and waits for each step
(``tests/torch_train_common.py::synchronous``), which makes it a steady
oracle on a loaded machine.
"""

import dataclasses
import json

import numpy as np
import pytest
from scipy.signal import resample_poly

import jax

from asr_streaming_tpu.decode import beam as j_beam
from asr_streaming_tpu.models.asr import ASRConfig as JASRConfig
from asr_streaming_tpu.models.rnnt import RNNTConfig as JRNNTConfig
from asr_streaming_tpu.models.serving import (
    ServingConfig as JServingConfig, init_serving_params as j_init_params,
)
from asr_streaming_tpu.server.ws_server import (
    StreamingServer as JStreamingServer,
)
from asr_streaming_tpu.streaming.endpoint import EndpointRule as JEndpointRule
from asr_streaming_tpu.streaming.scheduler import Scheduler as JScheduler
from asr_streaming_tpu.utils.audio import EN_AUDIO as J_EN_AUDIO
from asr_streaming_tpu_torch.decode import beam as t_beam
from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
from asr_streaming_tpu_torch.models.serving import ServingConfig
from asr_streaming_tpu_torch.server.ws_server import StreamingServer
from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, params_from_numpy,
)
from tests.fixture_assets import asset_path
from tests.test_torch_server import (
    CTC_VOCAB, EN_HZ, EN_PIECES, GATES_OFF, SR, Running, _as_served,
    _ctc_streams, _pcm, _tones,
)
from tests.torch_train_common import synchronous

RULE = dict(must_contain_nonsilence=True, min_trailing_silence=0.8,
            min_utterance_length=0.0, max_relative_cost=float("inf"))
LEXICON = "ab\ta b |\ncd\tc d |\n"
ARPA = """\\data\\
ngram 1=5

\\1-grams:
-1.0\t<unk>
-99\t<s>
-0.7\t</s>
-0.5\tab
-0.5\tcd

\\end\\
"""


def _finals(messages):
    return [m for m in map(json.loads, messages[:-1])
            if m["result"]["final"]]


# ------------------------------------------------------------- Vietnamese

@pytest.fixture(scope="module")
def vi(tmp_path_factory):
    """Both packages' servers over the CTC fixture, each finals-rescored by
    its own Python lexicon+LM beam."""
    mp = pytest.MonkeyPatch()
    mp.setenv("ASR_NO_ASYNC_HARVEST", "1")
    d = tmp_path_factory.mktemp("lm")
    (d / "lexicon.txt").write_text(LEXICON)
    (d / "lm.arpa").write_text(ARPA)
    lex, lm = str(d / "lexicon.txt"), str(d / "lm.arpa")

    jcfg = JServingConfig(asr=JASRConfig.tiny(vocab_size=len(CTC_VOCAB)),
                          use_silero=False, **GATES_OFF)
    jparams = j_init_params(jax.random.PRNGKey(1), jcfg)
    trained = load_params(asset_path("overfit_ctc"))
    jparams["frontend"] = trained["frontend"]
    jparams["encoder"] = trained["encoder"]
    jsched = synchronous(JScheduler(
        jparams, jcfg, CTC_VOCAB, max_slots=3,
        rules={"trained": JEndpointRule(**RULE)}))
    assert jsched._async_harvest is False
    jax_server = Running(JStreamingServer(
        jsched, rescorer=j_beam.make_rescorer(CTC_VOCAB, lex, lm),
        tick_idle_sleep=0.002))
    mp.undo()

    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=len(CTC_VOCAB)),
                        use_silero=False, **GATES_OFF)
    sched = Scheduler(params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu"),
                      cfg, CTC_VOCAB, max_slots=3,
                      rules={"trained": EndpointRule(**RULE)}, device="cpu")
    port_server = Running(StreamingServer(
        sched, rescorer=t_beam.make_rescorer(CTC_VOCAB, lex, lm),
        tick_idle_sleep=0.002))
    with np.load(asset_path("overfit_ctc")) as z:
        golden = json.loads(str(z["__meta__"]))["golden"]
    yield golden, port_server, jax_server
    port_server.close()
    jax_server.close()


def test_vi_messages_equal_the_jax_server(vi):
    golden, port_server, jax_server = vi
    pcms = _ctc_streams(golden)
    got = port_server.serve(pcms)
    finals = [f for m in got for f in _finals(m)]
    assert golden in [f["result"]["hypotheses"][0]["transcript"]
                      for f in finals]
    # the rescored finals carry the alignment-derived fields
    assert all(f["result"]["hypotheses"][0]["word_alignment"]
               and f["snr"] != 0.0 and f["total_length"] > 0
               for f in finals), finals
    assert got == jax_server.serve(pcms)


def test_vi_8khz_messages_equal_the_jax_server(vi):
    golden, port_server, jax_server = vi
    pcm8k = _pcm(resample_poly(_as_served(_ctc_streams(golden)[0]), 1, 2))
    got = port_server.serve([pcm8k], rate=8000)
    assert [f["result"]["hypotheses"][0]["transcript"]
            for f in _finals(got[0])] == [golden]
    assert got == jax_server.serve([pcm8k], rate=8000)


# ---------------------------------------------------------------- English

def test_en_beam_partials_messages_equal_the_jax_server(monkeypatch):
    """server-en.yaml's mode: the device beam (width 4 at this size)
    behind the trained VAD, finals from the beam (no rescorer)."""
    monkeypatch.setenv("ASR_NO_ASYNC_HARVEST", "1")
    path = asset_path("overfit_rnnt")
    with np.load(path) as z:
        golden = json.loads(str(z["__meta__"]))["beam_golden"]
    kw = dict(model_kind="rnnt", use_silero=True, **GATES_OFF)
    sched_kw = dict(max_slots=2, language="en", en_beam_partials=True,
                    en_beam_width=4)
    jcfg = JServingConfig(
        asr=dataclasses.replace(JASRConfig.tiny(), audio=J_EN_AUDIO),
        rnnt=JRNNTConfig.tiny(vocab_size=len(EN_PIECES)), **kw)
    jparams = j_init_params(jax.random.PRNGKey(1), jcfg)
    jparams.update(load_params(path))
    jparams["vad"] = load_params(asset_path("overfit_rnnt_vad"))
    jax_server = Running(JStreamingServer(
        synchronous(JScheduler(jparams, jcfg, EN_PIECES,
                                rules={"r": JEndpointRule(**RULE)},
                                **sched_kw)),
        tick_idle_sleep=0.002))
    cfg = ServingConfig(
        asr=dataclasses.replace(ASRConfig.tiny(), audio=EN_AUDIO),
        rnnt=RNNTConfig.tiny(vocab_size=len(EN_PIECES)), **kw)
    port_server = Running(StreamingServer(
        Scheduler(params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"),
                  cfg, EN_PIECES, rules={"r": EndpointRule(**RULE)},
                  device="cpu", **sched_kw),
        tick_idle_sleep=0.002))
    one = _tones(golden, 3.84, EN_HZ)
    pcms = [_pcm(one), _pcm(np.concatenate([one, one]))]
    try:
        got = port_server.serve(pcms)
        assert [[f["result"]["hypotheses"][0]["transcript"].strip()
                 for f in _finals(m)] for m in got] == \
            [[golden], [golden, golden]]
        assert got == jax_server.serve(pcms)
    finally:
        port_server.close()
        jax_server.close()
