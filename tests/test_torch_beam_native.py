"""The port's final-segment rescorers: the C++ lexicon+LM beam (built from
native/beamsearch/beam_decoder.cc into the port's _build/) and its Python
twin, against the JAX package's on a tiny lexicon + ARPA; and cases of
tests/test_kenlm_binary.py through the port's KenLM copies."""

import itertools
import types

import numpy as np
import pytest

from asr_streaming_tpu.decode import beam as j_beam
from asr_streaming_tpu.decode import beam_native as j_native
from asr_streaming_tpu.decode.kenlm_binary import (
    write_probing as j_write_probing,
)
from asr_streaming_tpu_torch.decode import beam as t_beam
from asr_streaming_tpu_torch.decode import beam_native as t_native
from asr_streaming_tpu_torch.decode.kenlm_binary import (
    KenLMBinary, load_lm, write_probing,
)
from tests.test_kenlm_binary import ARPA, LEXICON, VOCAB


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("lm")
    (d / "lm.arpa").write_text(ARPA)
    write_probing(str(d / "lm.arpa"), str(d / "lm.bin"))
    j_write_probing(str(d / "lm.arpa"), str(d / "lm_jax.bin"))
    (d / "lexicon.txt").write_text("\n".join(
        f"{w}\t{' '.join(toks)}" for w, toks in LEXICON.items()))
    return {k: str(d / n) for k, n in (
        ("arpa", "lm.arpa"), ("bin", "lm.bin"), ("bin_jax", "lm_jax.bin"),
        ("lexicon", "lexicon.txt"))}


def _peaky(path, V=5):
    em = np.full((len(path), V), -12.0, np.float32)
    em[np.arange(len(path)), path] = 0.0
    return em


def _noisy(T, seed, V=5):
    em = np.random.default_rng(seed).standard_normal((T, V))
    return (em - np.log(np.exp(em).sum(-1, keepdims=True))).astype(np.float32)


def _segment(em, offset):
    """What the server hands a rescorer (a FinalSegment's fields)."""
    pad = np.zeros((8, em.shape[1]), np.float32)      # rows past length
    return types.SimpleNamespace(emission=np.concatenate([em, pad]),
                                 length=len(em), offset=offset)


def test_native_library_builds_in_the_port():
    assert t_native.native_available()
    assert t_native.library_path().startswith(t_native.BUILD_DIR)


@pytest.mark.parametrize("lm_key", ["arpa", "bin"])
def test_rescorers_give_the_jax_alignments(assets, lm_key):
    lm = assets[lm_key]
    kw = dict(lm_weight=1.5, beam_size=20)
    port_native = t_native.make_native_rescorer(VOCAB, assets["lexicon"],
                                                lm, **kw)
    assert port_native is not None
    port_py = t_beam.make_rescorer(VOCAB, assets["lexicon"], lm, **kw)
    jax_py = j_beam.make_rescorer(VOCAB, assets["lexicon"], lm, **kw)
    # clear inputs: the four rescorers give one alignment
    for path, offset in (([2, 3, 1, 3, 2, 1], 7), ([0, 2, 3, 1, 0], 0),
                         ([2, 1, 2, 3, 4, 1], 50)):
        seg = _segment(_peaky(path), offset)
        want = jax_py(seg)
        assert want and port_py(seg) == want
        assert port_native(seg) == want
    # noisy inputs: each port rescorer equals its JAX twin exactly
    jax_native = (j_native.make_native_rescorer(VOCAB, assets["lexicon"], lm,
                                                **kw)
                  if j_native.native_available() else None)
    for seed in range(4):
        seg = _segment(_noisy(30, seed), 5)
        assert port_py(seg) == jax_py(seg)
        if jax_native is not None:
            assert port_native(seg) == jax_native(seg)


def test_probing_binary_bytes_equal_the_jax_writer(assets):
    with open(assets["bin"], "rb") as a, open(assets["bin_jax"], "rb") as b:
        assert a.read() == b.read()


def test_binary_scores_match_text_exhaustive(assets):
    """tests/test_kenlm_binary.py's case through the port's copies."""
    t = t_beam.ArpaLM.from_arpa(assets["arpa"])
    b = KenLMBinary(assets["bin"])
    assert isinstance(load_lm(assets["bin"]), KenLMBinary)
    assert b.order == t.order == 3
    words = ["<s>", "ab", "ba", "abc", "a", "OOVXX", "</s>"]
    for state_len in (0, 1, 2):
        for combo in itertools.product(words, repeat=state_len + 1):
            state, w = tuple(combo[:-1]), combo[-1]
            s_t, n_t = t.score(state, w)
            s_b, n_b = b.score(state, w)
            assert abs(s_t - s_b) < 1e-5, (state, w, s_t, s_b)
            assert n_t == n_b
            assert abs(t.finish(state + (w,)) - b.finish(state + (w,))) \
                < 1e-5


def test_native_beam_identical_text_vs_binary(assets):
    """tests/test_kenlm_binary.py's case through the port's decoder."""
    dec_t = t_native.NativeBeamDecoder(VOCAB, assets["lexicon"],
                                       assets["arpa"], lm_weight=1.5)
    dec_b = t_native.NativeBeamDecoder(VOCAB, assets["lexicon"],
                                       assets["bin"], lm_weight=1.5)
    for seed in range(4):
        em = _noisy(24, seed)
        r_t = dec_t.decode_full(em, offset=5)
        r_b = dec_b.decode_full(em, offset=5)
        assert r_t["transcript"] == r_b["transcript"]
        assert abs(r_t["score"] - r_b["score"]) < 1e-3
        assert r_t["alignment"] == r_b["alignment"]
