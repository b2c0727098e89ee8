"""The port's offline API and its tools vs the JAX package.

The tokenizer, forced alignment, ASRModel (at ASRConfig.tiny, the JAX
model's weights carried across in an .npz), the VAD segmenter (the
trained assets/bench_vad.npz), the WER/CER tool, the transcribe CLI and
the observability helpers.  Tolerances: emissions 2e-5 (f32, summation
order only), the trellis's finite values 1e-5 with its infinities in the
same places; texts, segments, timestamps, statistics and printed lines
equal.
"""

import json
import os
import sys
import wave as wave_mod

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.decode import alignment as jal
from asr_streaming_tpu.models import segmenter as jseg
from asr_streaming_tpu.models.api import ASRModel as JASRModel
from asr_streaming_tpu.models.asr import ASRConfig as JASRConfig
from asr_streaming_tpu.models.vad import (
    SileroConfig as JSileroConfig, init_silero_params as j_init_silero,
)
from asr_streaming_tpu.text import tokenizer as jtok
from asr_streaming_tpu.tools import evaluate as jev
from asr_streaming_tpu.utils import checkpoint as jckpt
from asr_streaming_tpu.utils.observability import (
    export_audacity_labels as j_export_labels,
)
from asr_streaming_tpu_torch.decode import alignment as tal
from asr_streaming_tpu_torch.models import segmenter as tseg
from asr_streaming_tpu_torch.models.api import ASRModel
from asr_streaming_tpu_torch.models.asr import ASRConfig, frame_waveform
from asr_streaming_tpu_torch.models.vad import (
    SileroConfig, init_silero_params,
)
from asr_streaming_tpu_torch.text import tokenizer as ttok
from asr_streaming_tpu_torch.tools import evaluate as tev
from asr_streaming_tpu_torch.utils.checkpoint import load_params
from asr_streaming_tpu_torch.utils.observability import (
    export_audacity_labels, torch_profile,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_VAD = os.path.join(ROOT, "assets", "bench_vad.npz")
VOCAB = ["-", "|"] + [chr(ord("a") + i) for i in range(19)]
LEXICON = {"ab": ["a", "b", "|"], "cd": ["c", "d", "|"]}
SR = 16000

# --------------------------------------------------------------- tokenizer

TOK_CASES = [
    ("Xin chào", ["-", "|", "xin", "chào", "a", "b", "c", "<<", ">>", "▁"],
     {"xin": ["xin", "|"], "chào": ["chào", "|"]}),
    ("xin abc", ["-", "|", "xin", "chào", "a", "b", "c", "<<", ">>", "▁"],
     {"xin": ["xin", "|"], "chào": ["chào", "|"]}),
    ("gin", ["-", "|", "g", "in", "gin", "▁", "<<", ">>"],
     {"gin": ["g", "in", "|"]}),
    ("Quýt, già!  quyên", ["-", "|", "q", "u", "ý", "t", "g", "i", "à",
                           "y", "ê", "n", "▁", "<<", ">>"], {}),
]


@pytest.mark.parametrize("sentence,vocab,lexicon", TOK_CASES,
                         ids=["known", "oov", "gi_special", "punct_tones"])
def test_tokenize_equals_jax(sentence, vocab, lexicon):
    got = ttok.tokenize(sentence, vocab, lexicon)
    assert got == jtok.tokenize(sentence, vocab, lexicon)
    assert got


@pytest.mark.parametrize("word", ["già", "quýt", "abc", "người", "ỹ"])
def test_refactor_tone_mark_equals_jax(word):
    assert ttok.refactor_tone_mark(word) == jtok.refactor_tone_mark(word)


# ---------------------------------------------------------- forced alignment

def _log_dirichlet(T, V, seed):
    return np.log(np.random.default_rng(seed).dirichlet(
        np.ones(V), size=T).astype(np.float32))


@pytest.mark.parametrize("T,tokens", [(12, [2, 3]), (40, [1, 4, 2, 2, 3]),
                                      (5, [1, 2, 3, 4, 1])],
                         ids=["short", "long", "tight"])
def test_ctc_trellis_equals_jax(T, tokens):
    em = _log_dirichlet(T, 5, T)
    want = np.asarray(jal.ctc_trellis(jnp.asarray(em),
                                      jnp.asarray(tokens, jnp.int32)))
    got = tal.ctc_trellis(torch.from_numpy(em),
                          torch.tensor(tokens)).numpy()
    assert got.shape == want.shape == (T + 1, len(tokens) + 1)
    assert np.array_equal(np.isposinf(got), np.isposinf(want))
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)


def _peaky(path, V=6, hot=-0.1, cold=-8.0):
    em = np.full((len(path), V), cold, np.float32)
    for t, tok in enumerate(path):
        em[t, tok] = hot
    return em


@pytest.mark.parametrize("em,ids,labels", [
    (_peaky([2, 0, 0, 3, 1, 0], V=4), [2, 3, 1], ["x", "y", "|"]),
    (_log_dirichlet(30, 6, 7), [2, 3, 1, 4, 5], ["a", "b", "|", "c", "d"]),
], ids=["peaky", "random"])
def test_force_align_segments_equal_jax(em, ids, labels):
    want = jal.force_align(em, ids, labels, audio_seconds=0.6)
    got = tal.force_align(em, ids, labels, audio_seconds=0.6)
    for g, w in zip(got, want):
        assert [s.label for s in g] == [s.label for s in w]
        np.testing.assert_allclose([(s.start, s.end, s.score) for s in g],
                                   [(s.start, s.end, s.score) for s in w],
                                   rtol=1e-5, atol=1e-6)
    assert [s.label for s in got[0]] == labels


# ------------------------------------------------------------------ ASRModel

def _speechy(seconds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(int(SR * seconds)) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(JAX model, checkpoint path of its weights)."""
    jmodel = JASRModel(cfg=JASRConfig.tiny(vocab_size=len(VOCAB)),
                       vocab=VOCAB, lexicon=LEXICON, seed=3)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny.npz")
    jckpt.save_params(path, jax.tree.map(np.asarray, jmodel.params))
    return jmodel, path


def _port_model(path):
    return ASRModel(cfg=ASRConfig.tiny(vocab_size=len(VOCAB)),
                    checkpoint=path, vocab=VOCAB, lexicon=LEXICON,
                    seed=5, device="cpu")


def test_asr_model_stream_emissions_transcribe_equal_jax(carried):
    jmodel, path = carried
    model = _port_model(path)
    wave = _speechy(2.0, 0)
    want = jmodel.emissions(wave)
    got = model.emissions(wave)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert model.transcribe(wave) == jmodel.transcribe(wave)
    # streaming over the same framing gives the offline emissions
    state, jstate = model.init_state(1), jmodel.init_state(1)
    for i, ch in enumerate(frame_waveform(wave, model.cfg.audio)):
        lp, state = model.stream(ch[None], state)
        jlp, jstate = jmodel.stream(ch[None], jstate)
        np.testing.assert_allclose(lp, jlp, rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(lp[0], got[i * lp.shape[1]:
                                               (i + 1) * lp.shape[1]],
                                   rtol=2e-5, atol=2e-5)


def test_asr_model_force_alignment_equals_jax(carried):
    jmodel, path = carried
    model = _port_model(path)
    wave = _speechy(1.0, 1)
    got = model.force_alignment(wave, "ab cd")
    want = jmodel.force_alignment(wave, "ab cd")
    for g, w in zip(got, want):
        assert [s.label for s in g] == [s.label for s in w]
        np.testing.assert_allclose([(s.start, s.end, s.score) for s in g],
                                   [(s.start, s.end, s.score) for s in w],
                                   rtol=1e-5, atol=1e-6)
    tokens, words = got
    assert [t.label for t in tokens] == ["a", "b", "|", "c", "d"]
    assert [w.label for w in words] == ["ab", "cd"]
    assert 0 <= words[0].start <= words[0].end <= words[1].start \
        <= words[1].end <= 1.0 + 1e-6


def test_asr_model_needs_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ASRModel(cfg=ASRConfig.tiny(), use_corpus=False)


# ----------------------------------------------------------------- segmenter

def _bursts(seed):
    """1 s silence, 2.5 s noise, 1 s silence, 3 s noise, 1.5 s silence."""
    rng = np.random.default_rng(seed)
    parts = []
    for kind, sec in (("s", 1.0), ("n", 2.5), ("s", 1.0), ("n", 3.0),
                      ("s", 1.5)):
        n = int(SR * sec)
        parts.append(np.zeros(n, np.float32) if kind == "s" else
                     (rng.standard_normal(n) * 0.3).astype(np.float32))
    return np.concatenate(parts)


def test_segmenter_timestamps_and_groups_equal_jax():
    wave = _bursts(0)
    jcfg, tcfg = JSileroConfig(), SileroConfig()
    jvad = jckpt.load_params(
        BENCH_VAD, like=j_init_silero(jax.random.PRNGKey(0), jcfg))
    tvad = load_params(BENCH_VAD, like=init_silero_params(
        torch.Generator().manual_seed(0), tcfg, "cpu"))
    want = jseg.get_speech_timestamps(jvad, jcfg, wave)
    got = tseg.get_speech_timestamps(tvad, tcfg, wave)
    assert got == want and len(got) == 2
    assert tseg.group_segments(got) == jseg.group_segments(want)
    assert tseg.group_segments(got, 0.5, 2.0) == \
        jseg.group_segments(want, 0.5, 2.0)
    probs = np.zeros(100, np.float32)
    probs[10:40] = probs[60:90] = 0.9
    for kw in ({}, dict(max_speech_duration_s=0.5), dict(threshold=0.95)):
        assert tseg.speech_timestamps_from_probs(probs, **kw) == \
            jseg.speech_timestamps_from_probs(probs, **kw)


# ------------------------------------------------------------------ evaluate

EDIT_CASES = [("a b c", "a b c"), ("a b c", "a x c"), ("a b c", "a b"),
              ("a b", "a x b y"), ("", "a b"), ("xin chào các bạn",
                                                "xin chào bạn")]


@pytest.mark.parametrize("ref,hyp", EDIT_CASES)
def test_evaluate_statistics_equal_jax(ref, hyp):
    assert tev.edit_stats(ref.split(), hyp.split()) == \
        tev.EditStats(**vars(jev.edit_stats(ref.split(), hyp.split())))
    for fn in ("word_error_rate", "char_error_rate"):
        for norm in (False, True):
            g = getattr(tev, fn)([ref, "Xin CHÀO!"], [hyp, "xin chào"],
                                 normalize=norm)
            w = getattr(jev, fn)([ref, "Xin CHÀO!"], [hyp, "xin chào"],
                                 normalize=norm)
            assert vars(g) == vars(w) and g.rate == w.rate
    assert tev.normalize_text("Xin CHÀO,  bạn!") == \
        jev.normalize_text("Xin CHÀO,  bạn!")


def test_evaluate_cli_json_equals_jax(tmp_path, capsys):
    ref, hyp = tmp_path / "ref.jsonl", tmp_path / "hyp.jsonl"
    ref.write_text("\n".join(
        json.dumps({"audio_filepath": "x.wav", "text": t})
        for t in ["một hai ba", "bốn năm", "Sáu, bảy!"]))
    hyp.write_text("\n".join(
        json.dumps({"text": t}) for t in ["một hai ba", "bốn sáu",
                                          "sáu bảy tám"]))
    outs = []
    for main in (jev.main, tev.main):
        main(["--manifest", str(ref), "--hyp-manifest", str(hyp),
              "--normalize", "--per-utt"])
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert json.loads(outs[1].splitlines()[-1])["ref_words"] == 7


# ---------------------------------------------------------------- transcribe

def _write_wav(path, audio):
    with wave_mod.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(np.clip(audio * 32767, -32768, 32767).astype(
            np.int16).tobytes())


@pytest.mark.parametrize("mode", [[], ["--segment", "--vad-weights",
                                       BENCH_VAD]],
                         ids=["greedy", "segment"])
def test_transcribe_cli_prints_what_jax_prints(carried, tmp_path, capsys,
                                               monkeypatch, mode):
    """Both CLIs with their ASRModel cut to ASRConfig.tiny on the carried
    weights (tests/test_evaluate.py's pattern), the port's on the CPU."""
    from asr_streaming_tpu.tools.transcribe import main as jmain
    from asr_streaming_tpu_torch.tools.transcribe import main as tmain
    _, path = carried
    wav = tmp_path / "long.wav"
    _write_wav(wav, _bursts(2))
    jinit, tinit = JASRModel.__init__, ASRModel.__init__

    def jtiny(self, cfg=None, **kw):
        jinit(self, cfg=JASRConfig.tiny(vocab_size=len(VOCAB)),
              vocab=VOCAB, checkpoint=path)

    def ttiny(self, cfg=None, **kw):
        tinit(self, cfg=ASRConfig.tiny(vocab_size=len(VOCAB)),
              vocab=VOCAB, checkpoint=path, device=kw["device"])

    monkeypatch.setattr(JASRModel, "__init__", jtiny)
    monkeypatch.setattr(ASRModel, "__init__", ttiny)
    monkeypatch.setattr(sys, "argv", ["transcribe", str(wav), *mode])
    jmain()
    want = capsys.readouterr().out
    tmain([str(wav), *mode, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    if mode:
        assert len(got.splitlines()) == 1 and "1.00" in got   # one group
    else:
        assert got.startswith("greedy: ")


# ------------------------------------------------------------- observability

def test_torch_profile_writes_a_trace_on_the_cpu(tmp_path):
    with torch_profile(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())


def test_export_audacity_labels_writes_the_same_file(tmp_path):
    segs = [(0.0, 1.5, "hello"), (2.0, 3.25, "xin chào")]
    export_audacity_labels(segs, str(tmp_path / "t.txt"))
    j_export_labels(segs, str(tmp_path / "j.txt"))
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
