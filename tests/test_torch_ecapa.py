"""The port's ECAPA-TDNN and SpeakerVerifier against the JAX package's.

The same numpy-seeded parameters (random weights and BatchNorm
statistics) and features go through both ``ecapa_embed`` at
``EcapaConfig.tiny``, with and without ``feat_lens``: the unit-norm
embeddings agree to atol 1e-5.  Both ``SpeakerVerifier``s, enrolled on the
same wave, give scores that agree to 1e-5 and equal decisions on every
bucket, past 16 s (truncated) and for an empty wave.  The committed
``assets/test_fixtures/speaker_loop.npz`` loads into both, and on the two
synthetic voices of tests/test_speaker_loop.py the enrolled voice
verifies and the other does not, in both packages.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import ecapa as J
from asr_streaming_tpu.utils.checkpoint import load_params as j_load
from asr_streaming_tpu.utils.checkpoint import save_params as j_save
from asr_streaming_tpu_torch.models import ecapa as T
from asr_streaming_tpu_torch.utils.checkpoint import _flatten
from tests.fixture_assets import asset_path
from tests.test_speaker_loop import VOICES

SR = 16000

ATOL = 1e-5
JCFG = J.EcapaConfig.tiny()
TCFG = T.EcapaConfig.tiny()


def _numpy_params(seed=0, bn_stats=True):
    """ECAPA weights in the JAX tree drawn from a numpy generator (each
    conv and the output layer uniform in +-1/sqrt(fan_in), as the init
    draws them); with ``bn_stats`` the BatchNorm statistics, scales and
    the biases are drawn too, so every term of the graph is exercised."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda: J.init_ecapa_params(jax.random.PRNGKey(0), JCFG))

    def draw(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name in ("w", "out_w"):
            fan_in = a.shape[0] if name == "out_w" else a.shape[1] * a.shape[2]
            bound = 1.0 / np.sqrt(fan_in)
            return rng.uniform(-bound, bound, a.shape).astype(np.float32)
        if not bn_stats:        # the init's BatchNorm and zero biases
            fill = 1.0 if name in ("scale", "var") else 0.0
            return np.full(a.shape, fill, np.float32)
        if name == "var":
            return (1.0 + 0.2 * rng.random(a.shape)).astype(np.float32)
        if name in ("mean", "bias", "b", "out_b"):
            return (0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        return (1.0 + 0.1 * rng.standard_normal(a.shape)    # scale
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_init_tree_is_the_jax_layout():
    """Seeded init gives the JAX package's tree: same keys, shapes, dtypes,
    at the tiny and the full width."""
    from asr_streaming_tpu.utils.checkpoint import SEP
    for jc, tc in ((JCFG, TCFG), (J.EcapaConfig(), T.EcapaConfig())):
        shapes = jax.eval_shape(
            lambda: J.init_ecapa_params(jax.random.PRNGKey(0), jc))
        want = {SEP.join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in kp): (tuple(v.shape), np.dtype(v.dtype))
                for kp, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
        got = {k: (v.shape, v.dtype) for k, v in
               _flatten(T.init_ecapa_params(0, tc, "cpu")).items()}
        assert got == want


def _jflat(tree):
    from asr_streaming_tpu.utils.checkpoint import _flatten as jf
    return jf(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("with_lens", [False, True], ids=["full", "lens"])
def test_embeddings_match_jax(with_lens):
    p = _numpy_params()
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((3, 70, JCFG.n_mels)).astype(np.float32)
    lens = np.array([70, 52, 31], np.int32)
    jl = jnp.asarray(lens) if with_lens else None
    tl = torch.from_numpy(lens) if with_lens else None
    embed = jax.jit(J.ecapa_embed, static_argnums=1)
    want = np.asarray(embed(jax.tree.map(jnp.asarray, p), JCFG,
                            jnp.asarray(feats), jl))
    got = T.ecapa_embed(T.ecapa_params_from_numpy(p, "cpu"), TCFG,
                        torch.from_numpy(feats), tl).numpy()
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_npz_params_load_through_params_from_numpy(tmp_path):
    """A JAX-written .npz (lists keyed 0, 1, ...) loads into the port."""
    p = _numpy_params(2)
    path = str(tmp_path / "ecapa.npz")
    j_save(path, p)
    tree = T.load_ecapa_weights(path, TCFG)
    assert isinstance(tree["blocks"], list)
    assert isinstance(tree["blocks"][0]["res2"], list)
    want, got = _jflat(p), _flatten(tree)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    bad = dict(p, out_w=np.zeros((3, 3), np.float32))
    j_save(path, bad)
    with pytest.raises(ValueError, match="out_w"):
        T.load_ecapa_weights(path, TCFG)


# every bucket, an exact bucket edge, past 16 s (truncated), a tiny wave
LENGTHS = [1, 4000, 8000, 8001, 16000, 24000, 64000, 128000, 256000,
           300000]


def test_verifier_scores_and_decisions_match_jax():
    # BatchNorm at its initial statistics here: with the statistics drawn
    # as well, this random network turns the frontends' f32 roundoff
    # (4.8e-7 on the log-mel) into score differences near 1e-5, and each
    # package alone is then ~3.5e-6 per element from a float64
    # evaluation, so the tolerance would measure f32 noise.  The
    # embedding test above holds the drawn statistics to atol 1e-5.
    p = _numpy_params(3, bn_stats=False)
    rng = np.random.default_rng(4)
    enrol = (rng.standard_normal(20000) * 0.2).astype(np.float32)
    waves = [(rng.standard_normal(n) * rng.uniform(0.05, 0.4)
              ).astype(np.float32) for n in LENGTHS]
    waves.append(enrol[:15000] * 1.5)      # near the enrolled voice
    jv = J.SpeakerVerifier(jax.tree.map(jnp.asarray, p), JCFG, enrol)
    jscores = [jv.score(w) for w in waves]
    # a threshold between two scores, well away from every score, so
    # both decisions occur and a 1e-5 difference cannot flip one
    s = np.sort(jscores)
    gaps = np.diff(s)
    i = int(np.argmax(gaps))
    threshold = float((s[i] + s[i + 1]) / 2)
    assert gaps[i] > 1e-3
    jv.threshold = threshold
    tv = T.SpeakerVerifier(p, TCFG, enrol, threshold=threshold,
                           device="cpu")
    np.testing.assert_allclose(tv.enrolled, np.asarray(jv.enrolled),
                               rtol=0, atol=ATOL)
    for w, js in zip(waves, jscores):
        assert abs(tv.score(w) - js) <= ATOL, len(w)
        assert tv(w) == jv(w), len(w)
    decisions = [tv(w) for w in waves]
    assert any(decisions) and not all(decisions)
    empty = np.zeros(0, np.float32)
    assert tv(empty) is False and jv(empty) is False


def _utt(speaker: str, seed: int, seconds: float = 2.0) -> np.ndarray:
    """tests/test_speaker_loop.py::_utt, its generator seeded from
    (speaker, seed) directly instead of through the process-salted str
    hash, so the voices are the same in every run."""
    v = VOICES[speaker]
    rng = np.random.default_rng([ord(speaker), seed])
    n = int(SR * seconds)
    t = np.arange(n) / SR
    f0 = v["f0"] * (1.0 + 0.05 * np.sin(2 * np.pi * rng.uniform(1, 3) * t)
                    + rng.uniform(-0.04, 0.04))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    wave = np.zeros(n)
    for k in range(1, 30):
        freq = k * v["f0"]
        if freq > 3800:
            break
        gain = sum(np.exp(-((freq - fc) / bw) ** 2)
                   for fc, bw in v["formants"])
        wave += (gain + 0.05) / k * np.sin(k * phase)
    am = 0.5 + 0.5 * np.sin(
        2 * np.pi * v["syllable_hz"] * t + rng.uniform(0, 6.28))
    wave = wave * (0.3 + 0.7 * am)
    wave += 0.005 * rng.standard_normal(n)
    wave = wave / (np.max(np.abs(wave)) + 1e-9) * rng.uniform(0.22, 0.35)
    return wave.astype(np.float32)


@pytest.fixture(scope="module")
def fixture_params():
    like = jax.eval_shape(
        lambda: J.init_ecapa_params(jax.random.PRNGKey(0), JCFG))
    jp = jax.tree.map(np.asarray, j_load(asset_path("speaker_loop"),
                                         like=like))
    tp = T.load_ecapa_weights(asset_path("speaker_loop"), TCFG)
    return jp, tp


def test_speaker_loop_fixture_loads_into_both(fixture_params):
    jp, tp = fixture_params
    want, got = _jflat(jp), _flatten(tp)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_speaker_loop_voices_verify_in_both(fixture_params):
    """The trained fixture on the synthetic voices, at the threshold the
    fixture records: the enrolled voice A verifies on held-out
    utterances, B does not, in both packages, with scores within 1e-5."""
    jp, tp = fixture_params
    with np.load(asset_path("speaker_loop")) as z:
        threshold = json.loads(str(z["__meta__"]))["threshold"]
    enrol = _utt("A", 200)
    jv = J.SpeakerVerifier(jax.tree.map(jnp.asarray, jp), JCFG, enrol,
                           threshold=threshold)
    tv = T.SpeakerVerifier(tp, TCFG, enrol, threshold=threshold,
                           device="cpu")
    for seed in (100, 101, 102, 103):
        a, b = _utt("A", seed), _utt("B", seed)
        for w in (a, b):
            assert abs(tv.score(w) - jv.score(w)) <= ATOL
        assert jv(a) and tv(a)
        assert not jv(b) and not tv(b)
