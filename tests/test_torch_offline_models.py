"""The port's offline models against the JAX package's: the Squeezeformer
blocks, the offline encoders and heads, the iSTFT, the discriminators and
the TTS model.

The same seeded numpy inputs go through both.  The parameters are the
JAX inits' trees (``jax.eval_shape``) filled with seeded numpy values
(``numpy_tree``: so the BatchNorm statistics, the ``pe`` tables, the
scales and biases are not the init's constants) and carried over by
``params_from_numpy``; the JAX side runs jitted.  Forward values in f32
agree at rtol = atol = 1e-5; lengths, durations and masks exactly.
Randomness (MixStyle) is fed the JAX function's own draws.  The
discriminators are built narrow (channels 4-32) to keep the CPU time
small.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import blocks as jb
from asr_streaming_tpu.models import discriminators as jd
from asr_streaming_tpu.models import offline as jo
from asr_streaming_tpu.models import tts as jt
from asr_streaming_tpu.ops.istft import inverse_stft as j_istft
from asr_streaming_tpu_torch.models import blocks as tb
from asr_streaming_tpu_torch.models import discriminators as td
from asr_streaming_tpu_torch.models import offline as to
from asr_streaming_tpu_torch.models import tts as tt
from asr_streaming_tpu_torch.ops.istft import inverse_stft as t_istft
from tests.torch_train_common import (  # noqa: F401  (a fixture)
    numpy_tree, one_torch_thread, pairs, to_torch,
)

TOL = dict(rtol=1e-5, atol=1e-5)
D, H = 16, 4


def _t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, exact=False):
    """Every leaf of two (nested) outputs: f32 at 1e-5, integers exact."""
    for path, g, w in pairs(got, want):
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if exact or not np.issubdtype(w.dtype, np.floating):
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            np.testing.assert_allclose(g, w, err_msg=path, **TOL)


def _x(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _masks(lens, T):
    valid = np.arange(T)[None, :] < np.asarray(lens)[:, None]
    return ~(valid[:, None, :] & valid[:, :, None]), ~valid


# ------------------------------------------------------------------ blocks

def test_rel_pos_encoding_and_rel_to_abs_equal_the_jax_package():
    for G in (1, 2, 3):
        np.testing.assert_array_equal(tb.rel_pos_encoding(20, 8, G),
                                      jb.rel_pos_encoding(20, 8, G))
    s = _x(0, 2, 3, 5, 9)
    np.testing.assert_array_equal(tb._rel_to_abs(_t(s)).numpy(),
                                  np.asarray(jb._rel_to_abs(jnp.asarray(s))))


@pytest.mark.parametrize("G,T,lens", [(1, 9, [9, 6]), (2, 9, [9, 4]),
                                      (2, 8, [8, 5]), (3, 7, [7, 7])])
def test_grouped_mhsa_matches_jax(G, T, lens):
    """Group sizes 1-3, T a multiple of G or not (padded and masked)."""
    p = numpy_tree(lambda k: jb.init_mhsa_params(k, D, H, G, 32), G)
    x = _x(T, 2, T, D)
    mask, _ = _masks(lens, T)
    want = jax.jit(lambda *a: jb.grouped_mhsa(*a, H, G, 32))(
        p, jnp.asarray(x), jnp.asarray(mask))
    got = tb.grouped_mhsa(to_torch(p), _t(x), _t(mask), H, G, 32)
    close(got, want)


@pytest.fixture(scope="module")
def block():
    return numpy_tree(lambda k: jb.init_squeezeformer_block_params(
        k, D, H, 1, 32, 5), 3)


@pytest.mark.parametrize("training", [False, True])
def test_squeezeformer_block_and_its_parts_match_jax(block, training):
    x = _x(4, 2, 11, D)
    attn, conv = _masks([11, 7], 11)
    targs = (_t(attn), _t(conv))
    tp = to_torch(block)
    want = jax.jit(lambda p, x, a, c: (
        jb.ffn_block(p["ffn1"], x), jb.conv_block(p["conv"], x, c, training),
        jb.squeezeformer_block(p, x, a, c, H, 1, 32, training)))(
        block, jnp.asarray(x), jnp.asarray(attn), jnp.asarray(conv))
    close((tb.ffn_block(tp["ffn1"], _t(x)),
           tb.conv_block(tp["conv"], _t(x), targs[1], training),
           tb.squeezeformer_block(tp, _t(x), *targs, H, 1, 32, training)),
          want)


@pytest.mark.parametrize("training", [False, True])
def test_conv_subsampling_matches_jax(training):
    """Odd T and F; the second conv depthwise; BN on the batch or on the
    carried statistics."""
    p = numpy_tree(lambda k: jb.init_subsampling_params(k, 13, D, 4), 5)
    x, lens = _x(5, 3, 23, 13), np.array([23, 17, 9], np.int32)
    want = jax.jit(lambda *a: jb.conv_subsampling(*a, training))(
        p, jnp.asarray(x), jnp.asarray(lens))
    got = tb.conv_subsampling(to_torch(p), _t(x), _t(lens), training)
    close(got, want)


def test_pixel_ops_match_jax():
    p = numpy_tree(lambda k: jb.init_downsampling_pixel_params(k, D, 3), 6)
    x, lens = _x(6, 2, 13, D), np.array([13, 8], np.int32)
    attn, conv = _masks(lens, 13)

    def both(*a):
        down = jb.downsampling_pixel(*a, 3)
        return down, jb.upsampling_pixel(*down, 3)

    want = jax.jit(both)(p, jnp.asarray(x), jnp.asarray(lens),
                         jnp.asarray(attn), jnp.asarray(conv))
    got = tb.downsampling_pixel(to_torch(p), _t(x), _t(lens), _t(attn),
                                _t(conv), 3)
    close((got, tb.upsampling_pixel(*got, 3)), want)


@pytest.fixture(scope="module")
def styles():
    p = numpy_tree(lambda k: jb.init_adaptive_norm_params(k, D, 4), 7)
    x = _x(7, 5, 10, D, scale=3.0) + 1.0
    return p, x, np.array([10, 6, 9, 3, 10], np.int32), _x(8, 5, 4)


def test_adaptive_norm_matches_jax(styles):
    p, x, lens, s = styles
    close(tb.adaptive_norm(to_torch(p), _t(x), _t(lens), _t(s)),
          jax.jit(jb.adaptive_norm)(p, jnp.asarray(x), jnp.asarray(lens),
                                    jnp.asarray(s)))


@pytest.mark.parametrize("seed,probability", [(1, 1.0), (2, 0.5), (3, 0.0)])
def test_mixstyle_matches_jax_given_its_draws(styles, seed, probability):
    p, x, lens, s = styles
    key = jax.random.PRNGKey(seed)
    want = jax.jit(lambda *a: jb.mixstyle_norm(
        *a, training=True, probability=probability))(
        p, key, jnp.asarray(x), jnp.asarray(lens), jnp.asarray(s))
    # the JAX function's draws (blocks.py::mixstyle_norm's key splits)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = tb.MixStyleDraws(
        _t(jax.random.permutation(k1, 5)).long(),
        _t(jax.random.beta(k2, 0.1, 0.1, (5, 1))),
        _t(jax.random.uniform(k3, ()) <= probability))
    got = tb.mixstyle_norm(to_torch(p), draws, _t(x), _t(lens), _t(s))
    close(got, want)
    assert not np.array_equal(got.numpy(), x) or not bool(draws.apply)
    # the port's own draws: a permutation, weights in [0, 1], a flag
    own = tb.mixstyle_draws(torch.Generator().manual_seed(seed), 5,
                            probability)
    assert sorted(own.perm.tolist()) == list(range(5))
    assert own.weight.shape == (5, 1) and own.weight.dtype == torch.float32
    assert bool(((own.weight >= 0) & (own.weight <= 1)).all())
    assert bool(own.apply) == (probability == 1.0) or 0 < probability < 1
    np.testing.assert_array_equal(
        tb.mixstyle_norm(to_torch(p), own, _t(x), _t(lens), _t(s),
                         training=False).numpy(), x)


# --------------------------------------------------------- offline models

SQ = jo.SqueezeformerConfig(d_model=D, num_layers=2, attn_num_heads=H,
                            attn_group_size=2, attn_max_pos_encoding=32,
                            conv_kernel_size=5, input_dim=12,
                            subsampling_num_filters=4)
LING = jo.LinguisticConfig(vocab_size=20, d_model=D, num_layers=1,
                           attn_num_heads=H, attn_max_pos_encoding=32,
                           conv_kernel_size=5)


@pytest.mark.parametrize("training", [False, True])
def test_acoustic_encoder_matches_jax(training):
    p = numpy_tree(lambda k: jo.init_acoustic_encoder_params(k, SQ), 9)
    x, lens = _x(9, 2, 37, 12), np.array([37, 22], np.int32)
    want = jax.jit(lambda *a: jo.acoustic_encoder(a[0], SQ, *a[1:],
                                                  training))(
        p, jnp.asarray(x), jnp.asarray(lens))
    got = to.acoustic_encoder(to_torch(p), to.SqueezeformerConfig(
        **dataclasses.asdict(SQ)), _t(x), _t(lens), training)
    close(got, want)


def _text_inputs():
    tokens = np.array([[3, 5, 7, 2, 9, 11, 4, 0, 0],
                       [8, 1, 6, 13, 0, 0, 0, 0, 0]], np.int32)
    lens = np.array([7, 4], np.int32)
    words = np.array([[0, 0, 1, 1, 1, 2, 3, -1, -1],
                      [0, 1, 1, 2, -1, -1, -1, -1, -1]], np.int32)
    return tokens, lens, words


@pytest.mark.parametrize("forced,training", [(True, True), (True, False),
                                             (False, False)])
def test_linguistic_encoder_matches_jax(forced, training):
    """Teacher-forced durations (padded to the Tp word bound) or
    predicted ones (exp of the log-durations, pooled, ceil, >= 10)."""
    p = numpy_tree(lambda k: jo.init_linguistic_encoder_params(k, LING), 10)
    tokens, lens, words = _text_inputs()
    durs = np.array([[3, 5, 2, 4], [6, 1, 2, 0]], np.int32) if forced \
        else None
    want = jax.jit(lambda p, t, tl, w, d: jo.linguistic_encoder(
        p, LING, t, tl, w, word_durs=d, max_out=40, training=training))(
        p, *(None if a is None else jnp.asarray(a)
             for a in (tokens, lens, words, durs)))
    got = to.linguistic_encoder(
        to_torch(p), to.LinguisticConfig(**dataclasses.asdict(LING)),
        _t(tokens), _t(lens), _t(words),
        word_durs=None if durs is None else _t(durs), max_out=40,
        training=training)
    close(got, want)


def test_rnnt_heads_and_speaker_head_match_jax():
    pp = numpy_tree(lambda k: jo.init_predictor_params(k, 10, 8, D), 11)
    pj = numpy_tree(lambda k: jo.init_joint_params(k, D, 7), 12)
    pt = numpy_tree(lambda k: jo.init_temporal_pooling_params(k, D), 13)
    toks = np.array([[1, 4, 9], [0, 2, 2]], np.int32)
    h0 = _x(11, 2, D)
    enc, pred = _x(12, 2, 5, D), _x(13, 2, 3, D)
    lens = np.array([5, 2], np.int32)
    want = jax.jit(lambda pp, pj, pt, toks, h0, enc, pred, lens: (
        jo.predictor_network(pp, toks), jo.predictor_network(pp, toks, h0),
        jo.joint_network(pj, enc, pred),
        jo.temporal_pooling_decoder(pt, enc, lens)))(
        pp, pj, pt, *map(jnp.asarray, (toks, h0, enc, pred, lens)))
    pp, pj, pt = to_torch(pp), to_torch(pj), to_torch(pt)
    got = (to.predictor_network(pp, _t(toks)),
           to.predictor_network(pp, _t(toks), _t(h0)),
           to.joint_network(pj, _t(enc), _t(pred)),
           to.temporal_pooling_decoder(pt, _t(enc), _t(lens)))
    close(got, want)


@pytest.mark.parametrize("n_fft,win,hop", [(64, 64, 16), (64, 40, 16),
                                           (30, 20, 7)])
def test_inverse_stft_matches_jax(n_fft, win, hop):
    """Window shorter than n_fft (centred, zero-padded) and an odd hop."""
    re, im = _x(14, 2, n_fft // 2 + 1, 13), _x(15, 2, n_fft // 2 + 1, 13)
    spec = (re + 1j * im).astype(np.complex64)
    want = jax.jit(lambda s: j_istft(s, n_fft, win, hop))(jnp.asarray(spec))
    got = t_istft(_t(spec), n_fft, win, hop)
    assert got.dtype == torch.float32
    close(got, want)


def test_waveform_decoder_matches_jax():
    """audio_lens from the f32 product of the JAX package, exact."""
    cfg = dataclasses.replace(SQ, num_layers=1)
    p = numpy_tree(lambda k: jo.init_waveform_decoder_params(k, cfg, 32),
                   16)
    x = _x(16, 3, 13, D, scale=0.3)
    lens = np.array([13, 9, 5], np.int32)
    want = jax.jit(lambda p, x, lens: jo.waveform_decoder(
        p, cfg, x, lens, 32, 24, 8, training=True))(
        p, jnp.asarray(x), jnp.asarray(lens))
    got = to.waveform_decoder(to_torch(p), to.SqueezeformerConfig(
        **dataclasses.asdict(cfg)), _t(x), _t(lens), 32, 24, 8,
        training=True)
    close(got, want)


# ---------------------------------------------------------- discriminators

NARROW = (4, 8, 16, 32)


@pytest.fixture(scope="module")
def discs():
    mpd = numpy_tree(lambda k: jd.init_period_discriminator(k, NARROW), 17)
    mrd = numpy_tree(lambda k: jd.init_resolution_discriminator(k, NARROW),
                     18)
    mbd = numpy_tree(jd.init_multi_band_discriminator, 19)
    mbd["filters"] = jnp.asarray(jd.pqmf_filterbank(4))
    return mpd, mrd, mbd


@pytest.mark.parametrize("T", [1, 2, 9, 157])
def test_period_discriminator_matches_jax(discs, T):
    """Reflect padding (periodic past T - 1), constant at T = 1."""
    wave = _x(18, 2, T, scale=0.3)
    periods = (2, 5, 11)
    want = jax.jit(lambda p, w: [jd.period_discriminator(p, w, n)
                                 for n in periods])(discs[0],
                                                    jnp.asarray(wave))
    tp = to_torch(discs[0])
    close([td.period_discriminator(tp, _t(wave), n) for n in periods], want)


@pytest.mark.parametrize("T,res", [(1001, (64, 48, 12)),
                                   (1187, (128, 100, 25)),
                                   (777, (100, 60, 13))])
def test_resolution_discriminator_matches_jax(discs, T, res):
    """XLA "SAME" at stride 2 on odd spectrogram sizes."""
    wave = _x(19, 2, T, scale=0.3)
    want = jax.jit(lambda p, w: jd.resolution_discriminator(p, w, res))(
        discs[1], jnp.asarray(wave))
    got = td.resolution_discriminator(to_torch(discs[1]), _t(wave), res)
    assert any(f.shape[2] % 2 for f in got[1][:-1]) or \
        any(f.shape[3] % 2 for f in got[1][:-1])
    close(got, want)


@pytest.mark.parametrize("T", [1024, 1099])
def test_pqmf_and_multi_band_discriminator_match_jax(discs, T):
    np.testing.assert_array_equal(td.pqmf_filterbank(4),
                                  jd.pqmf_filterbank(4))
    wave = _x(20, 2, T, scale=0.3)
    filters = jd.pqmf_filterbank(4)
    want = jax.jit(lambda p, w, f: (jd.pqmf_analysis(w, f),
                                    jd.multi_band_discriminator(p, w)))(
        discs[2], jnp.asarray(wave), jnp.asarray(filters))
    close((td.pqmf_analysis(_t(wave), _t(filters)),
           td.multi_band_discriminator(to_torch(discs[2]), _t(wave))), want)


def test_multi_discriminators_match_jax(discs):
    """The ensembles: the static periods / resolutions beside the tree."""
    wave = _x(21, 2, 2100, scale=0.3)
    mpd = {"periods": [2, 3], "discs": [discs[0], discs[0]]}
    mrd = {"resolutions": [(128, 100, 25), (256, 200, 50)],
           "discs": [discs[1], discs[1]]}
    for j_fn, t_fn, p in ((jd.multi_period_discriminator,
                           td.multi_period_discriminator, mpd),
                          (jd.multi_resolution_discriminator,
                           td.multi_resolution_discriminator, mrd)):
        static = {k: v for k, v in p.items() if k != "discs"}
        got = t_fn({**static, "discs": to_torch(p["discs"])}, _t(wave))
        want = jax.jit(lambda d, w: j_fn({**static, "discs": d}, w))(
            p["discs"], jnp.asarray(wave))
        close(got, want)


# --------------------------------------------------------------------- TTS

@pytest.fixture(scope="module")
def tts():
    cfg = jt.TTSConfig.tiny()
    return cfg, numpy_tree(lambda k: jt.init_tts_params(k, cfg), 22)


@pytest.mark.parametrize("forced", [True, False])
def test_synthesize_matches_jax(tts, forced):
    """Audio at 1e-5; audio lengths and predicted durations exact in
    shape, the lengths exact in value."""
    jcfg, p = tts
    cfg = tt.TTSConfig.tiny()
    tokens, lens, words = _text_inputs()
    durs = np.array([[30, 50, 20, 40], [60, 10, 25, 0]], np.int32) \
        if forced else None
    want = jax.jit(lambda p, t, tl, w, d: jt.synthesize(
        p, jcfg, t, tl, w, word_durs=d))(
        p, *(None if a is None else jnp.asarray(a)
             for a in (tokens, lens, words, durs)))
    got = tt.synthesize(to_torch(p), cfg, _t(tokens), _t(lens), _t(words),
                        word_durs=None if durs is None else _t(durs))
    close(got, want)
    assert got[1].tolist() == np.asarray(want[1]).tolist()
