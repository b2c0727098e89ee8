"""The port's n-gram LM library, OOV recognizer and TTS-manifest tool
against the JAX package's.

The text modules are pure Python copies: every score, log-score,
perplexity and corrected sentence equals the JAX package's exactly on one
corpus.  The manifest tool's functions equal the JAX tool's; its CLI
writes the JAX tool's JSONL line for line, with the stub aligner of
tests/test_make_tts_manifest.py and with the overfit CTC fixture aligning
tone sentences on the CPU.  Without a card the CLI raises unless given
``--device cpu``.
"""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import asr_streaming_tpu.models.api as japi
from asr_streaming_tpu.models.asr import ASRConfig as JASRConfig
from asr_streaming_tpu.text import ngram_lm as jlm
from asr_streaming_tpu.text import oov as joov
from asr_streaming_tpu.tools import make_tts_manifest as jtool
import asr_streaming_tpu_torch.models.api as tapi
from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.text import ngram_lm as tlm
from asr_streaming_tpu_torch.text import oov as toov
from asr_streaming_tpu_torch.tools import make_tts_manifest as ttool
from tests.torch_train_common import (  # noqa: F401  (a fixture)
    one_torch_thread, write_wav,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "assets", "test_fixtures", "overfit_ctc.npz")

CORPUS = [s.split() for s in (
    "tôi đi học về nhà", "tôi đi chợ mua rau", "hôm nay tôi đi học",
    "mẹ đi chợ về nhà", "trời mưa tôi ở nhà", "đi học về tôi ăn cơm",
    "hôm nay trời mưa to", "mẹ mua rau ở chợ")]
ORDER = 3


# ----------------------------------------------------------------- n-grams

def _fit(mod, cls, **kw):
    model = getattr(mod, cls)(ORDER, **kw)
    model.fit(mod.everygrams(mod.pad_sequence(s, ORDER), ORDER)
              for s in CORPUS)
    return model


def test_ngram_utilities_equal_the_jax_package():
    seq = CORPUS[0]
    for n in (1, 2, 3):
        assert list(tlm.ngrams(seq, n)) == list(jlm.ngrams(seq, n))
        assert tlm.pad_sequence(seq, n) == jlm.pad_sequence(seq, n)
        assert tlm.pad_sequence(seq, n, right=False) == \
            jlm.pad_sequence(seq, n, right=False)
        assert list(tlm.everygrams(seq, n)) == list(jlm.everygrams(seq, n))
    words = [w for s in CORPUS for w in s] + ["hiếm"]
    tv, jv = tlm.Vocabulary(words, 2), jlm.Vocabulary(words, 2)
    assert len(tv) == len(jv)
    assert [tv.lookup(w) for w in words] == [jv.lookup(w) for w in words]
    tc, jc = tlm.NgramCounter(), jlm.NgramCounter()
    grams = list(tlm.everygrams(tlm.pad_sequence(CORPUS[1], 3), 3))
    tc.update(grams)
    jc.update(grams)
    for g in grams:
        assert tc.context_counts(g[:-1]) == jc.context_counts(g[:-1])


@pytest.mark.parametrize("cls,kw", [("MLE", {}),
                                    ("WittenBellInterpolated", {}),
                                    ("KneserNeyInterpolated",
                                     {"discount": 0.5})])
def test_ngram_scores_equal_the_jax_package(cls, kw):
    tm, jm = _fit(tlm, cls, **kw), _fit(jlm, cls, **kw)
    vocab = sorted({w for s in CORPUS for w in s}) + ["</s>", "lạ"]
    contexts = [(), ("tôi",), ("đi",), ("tôi", "đi"), ("<s>", "<s>"),
                ("lạ", "đi"), ("mẹ", "mua")]
    for ctx in contexts:
        for w in vocab:
            assert tm.score(w, ctx) == jm.score(w, ctx), (w, ctx)
            assert tm.logscore(w, ctx) == jm.logscore(w, ctx), (w, ctx)
    test = [g for g in jlm.everygrams(jlm.pad_sequence(
        "hôm nay tôi đi chợ".split(), ORDER), ORDER) if len(g) == ORDER]
    assert tm.entropy(test) == jm.entropy(test)
    assert tm.perplexity(test) == jm.perplexity(test)


# --------------------------------------------------------------------- OOV

OOV_ENTRIES = ["chatgpt | chát gi pi ti, chat gpt", "bitcoin | bít coin",
               "blockchain | bờ lốc chên", "tiktok"]
SENTENCES = ["mua <<bitcoi>> ngay", "hỏi <<chatgp>> về bít coin",
             "dùng chát gi pi ti đi", "<<▁block▁chai>> và bờ lốc chên",
             "<<zzzzzz>> không có", "xem <<tiktak>> đi"]


def test_oov_recognizer_equals_the_jax_package():
    t, j = toov.OOVRecognizer(OOV_ENTRIES), joov.OOVRecognizer(OOV_ENTRIES)
    assert t.words == j.words and t.soundlikes == j.soundlikes
    for s in SENTENCES:
        assert t.correct_spelling(s) == j.correct_spelling(s)
        assert t.capture_soundlike(s) == j.capture_soundlike(s)
        assert t(s) == j(s)
    ctxs = [("<<",), ("<<", "b", "i", "t", "c", "o"), ("c", "h", "a"),
            ("x", "y")]
    for ctx in ctxs:
        for ch in "abcdiotz>":
            assert t.char_score(ch, ctx) == j.char_score(ch, ctx)
    ts, js = toov.SpellIndex(2), joov.SpellIndex(2)
    for w, c in (("blockchain", 5), ("blocking", 1), ("block", 2)):
        ts.add(w, c)
        js.add(w, c)
    for q in ("blockchai", "blockcain", "blok", "zzzzzz", "blockin"):
        assert ts.lookup(q) == js.lookup(q)


# ------------------------------------------------------------ TTS manifest

def _seg(start, end):
    return SimpleNamespace(start=start, end=end)


SEGMENTS = [
    ([_seg(0.2, 0.5), _seg(0.7, 1.1), _seg(1.3, 1.8)], 2.0),
    ([_seg(0.1, 0.4)], 1.0),
    ([], 1.0),
    ([_seg(i * 0.01, i * 0.01 + 0.005) for i in range(12)], 0.1),
    ([_seg(0.0, 0.001), _seg(0.002, 0.003), _seg(0.9, 1.0)], 1.03),
]


@pytest.mark.parametrize("case", range(len(SEGMENTS)))
def test_word_durations_equal_the_jax_tool(case):
    segs, seconds = SEGMENTS[case]
    for hop in (160, 256):
        got = ttool.word_durations_from_alignment(segs, seconds, 16000, hop)
        assert got == jtool.word_durations_from_alignment(segs, seconds,
                                                          16000, hop)
        assert not got or sum(got) == int(seconds * 16000) // hop


def test_tokens_and_words_equal_the_jax_tool():
    vocab = ["-", "|", "xin", "chao", "cac", "ban", "a", "b"]
    lexicon = {"xin": ["xin"], "chao": ["chao"], "ab": ["a", "b", "|"]}
    for text in ("xin chao ban", "ab xin ab", "zz chao", ""):
        assert ttool.tokens_and_words(text, vocab, lexicon) == \
            jtool.tokens_and_words(text, vocab, lexicon)


def _asr_manifest(tmp_path, texts, audio):
    lines = []
    for i, (text, wave) in enumerate(zip(texts, audio)):
        p = tmp_path / f"u{i}.wav"
        write_wav(p, wave)
        lines.append(json.dumps({"audio_filepath": str(p), "text": text}))
    m = tmp_path / "asr.jsonl"
    m.write_text("\n".join(lines) + "\n")
    return str(m)


def _run_both(tmp_path, manifest, args=()):
    out = {}
    for name, tool in (("jax", jtool), ("port", ttool)):
        path = tmp_path / f"{name}.jsonl"
        extra = ["--device", "cpu"] if name == "port" else []
        tool.main(["--manifest", manifest, "--out", str(path), *args,
                   *extra])
        out[name] = path.read_text().splitlines()
    return out["port"], out["jax"]


def test_manifest_cli_with_the_stub_aligner_equals_the_jax_tool(
        tmp_path, monkeypatch):
    """tests/test_make_tts_manifest.py:45's stub model, in both tools."""
    vocab = ["-", "|", "xin", "chao"]
    lexicon = {"xin": ["xin"], "chao": ["chao"]}

    class StubModel:
        def __init__(self, **_kw):
            self.cfg = SimpleNamespace(
                audio=SimpleNamespace(sample_rate=16000))
            self.vocab = vocab
            self.lexicon = lexicon

        def force_alignment(self, wave_arr, text):
            words = text.split()
            if "fail" in words:
                raise ValueError("no path")
            return [], [_seg(0.1 + 0.4 * i, 0.4 + 0.4 * i)
                        for i in range(len(words) + ("extra" in words))]

    monkeypatch.setattr(japi, "ASRModel", StubModel)
    monkeypatch.setattr(tapi, "ASRModel", StubModel)
    rng = np.random.default_rng(0)
    texts = ["xin chao", "xin", "chao fail", "xin chao extra",
             "chao xin chao"]
    audio = [rng.standard_normal(int(16000 * s)) * 0.1
             for s in (1.0, 0.5, 1.0, 1.0, 0.005)]
    manifest = _asr_manifest(tmp_path, texts, audio)
    got, want = _run_both(tmp_path, manifest, ["--hop-length", "128"])
    assert got == want and len(got) == 2
    e = json.loads(got[0])
    assert e["word_idxs"] == [0, 1] and sum(e["word_durations"]) == 125


def test_manifest_cli_aligning_with_the_fixture_equals_the_jax_tool(
        tmp_path, monkeypatch):
    """The overfit CTC fixture (ASRConfig.tiny, "ab cd") aligns tone
    sentences in both tools on the CPU: the same JSONL."""
    vocab = ["-", "|", "a", "b", "c", "d"]
    lexicon = {w: list(w) + ["|"] for w in ("ab", "cd", "dc", "ba", "ad",
                                            "bc")}
    jmodel, tmodel = japi.ASRModel, tapi.ASRModel
    monkeypatch.setattr(japi, "ASRModel", lambda **kw: jmodel(
        cfg=JASRConfig.tiny(vocab_size=6), vocab=vocab, lexicon=lexicon,
        use_corpus=False, **kw))
    monkeypatch.setattr(tapi, "ASRModel", lambda **kw: tmodel(
        cfg=ASRConfig.tiny(vocab_size=6), vocab=vocab, lexicon=lexicon,
        use_corpus=False, **kw))
    texts = ["ab cd", "dc ba", "ad bc"]
    audio = [_tones(t, 3.84) for t in texts]
    manifest = _asr_manifest(tmp_path, texts, audio)
    got, want = _run_both(tmp_path, manifest, ["--checkpoint", FIXTURE])
    assert got == want and len(got) == 3
    for line in got:
        e = json.loads(line)
        assert e["word_idxs"] == [0, 0, 1, 1]
        assert sum(e["word_durations"]) == int(3.84 * 16000) // 160


def _tones(s, total, sr=16000):
    """The tone sentences of tests/test_overfit_e2e.py."""
    tone_hz = {"a": 350.0, "b": 700.0, "c": 1400.0, "d": 2100.0, " ": 1000.0}
    parts = []
    for ch in s:
        t = np.arange(int(sr * 0.24)) / sr
        wave = 0.3 * np.sin(2 * np.pi * tone_hz[ch] * t)
        ramp = np.minimum(1.0, np.arange(len(t)) / (0.010 * sr))
        parts.extend([(wave * ramp * ramp[::-1]).astype(np.float32),
                      np.zeros(int(sr * 0.08), np.float32)])
    audio = np.concatenate(parts)
    return np.pad(audio, (0, int(sr * total) - len(audio)))


def test_manifest_cli_needs_a_card_unless_given_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttool.main(["--manifest", str(tmp_path / "none.jsonl"), "--out",
                    str(tmp_path / "out.jsonl")])
