"""The port's training data, augmentation, VAD and speaker trainers
against the JAX package's.

``bucket_batches``, ``window_labels``, the noise and the overlap give
the JAX package's arrays exactly, the RIR reverb (an FFT product) within
1e-6; SpecAugment's masking equals the JAX
function's given the same draws (the port draws from a torch.Generator,
which cannot equal jax.random), and its draws stay in range.  One VAD
step (full SileroConfig) and one speaker step (SpeakerTrainConfig.tiny,
ECAPA with batch-statistics BatchNorm): the loss within 1e-5 and every
leaf's gradient within 1e-4 relative L2 of ``jax.value_and_grad``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models.ecapa import ecapa_embed as j_ecapa_embed
from asr_streaming_tpu.models.vad import (
    SileroConfig as JSileroConfig, init_silero_params as j_init_silero,
)
from asr_streaming_tpu.train import augment as jaug
from asr_streaming_tpu.train import data as jdata
from asr_streaming_tpu.train import speaker as jspk
from asr_streaming_tpu.train import vad as jvad
from asr_streaming_tpu_torch.models.ecapa import ecapa_embed
from asr_streaming_tpu_torch.models.vad import SileroConfig
from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
from asr_streaming_tpu_torch.train import augment as taug
from asr_streaming_tpu_torch.train import data as tdata
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train import speaker as tspk
from asr_streaming_tpu_torch.train import vad as tvad
from tests.torch_train_common import (
    assert_trees_rel_l2, noise_manifest, to_torch, write_wav,
)


# ------------------------------------------------------------------ data

def test_bucket_batches_equal_the_jax_package(tmp_path):
    vocab = placeholder_vocab(40)
    m = noise_manifest(tmp_path, n=7, seconds=0.6, step=0.45,
                       extra=lambda i: {"text": " ".join(
                           f"t{(i * 5 + k) % 37}" for k in range(i + 1))})
    lexicon = {f"t{k}": [f"t{k}"] for k in range(37)}
    jds = jdata.SpeechRecognitionDataset(m, vocab, lexicon)
    tds = tdata.SpeechRecognitionDataset(m, vocab, lexicon)
    assert tdata.load_manifest(m) == jdata.load_manifest(m)
    for seed in (0, 3, None):
        kw = dict(buckets_seconds=(1.0, 2.0, 4.0), token_bucket=8,
                  shuffle_seed=seed)
        jb = list(jdata.bucket_batches(jds, 3, **kw))
        tb = list(tdata.bucket_batches(tds, 3, **kw))
        assert len(tb) == len(jb) >= 3
        for a, b in zip(tb, jb):
            for f in ("waves", "wave_lens", "tokens", "token_lens"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        assert any(b.token_lens.max() > 1 for b in tb)


def test_window_labels_equal_the_jax_package():
    rng = np.random.default_rng(2)
    wave = (rng.standard_normal((3, 5000)) * 0.004).astype(np.float32)
    wave[0, 700:900] = 0.3
    wave[2, 4900:] = -0.2
    for w in (wave, wave[1]):
        got = tvad.window_labels(w, SileroConfig())
        want = jvad.window_labels(w, JSileroConfig())
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("name", ["noise_long", "noise_short", "overlap",
                                  "rir"])
def test_waveform_augmentations_equal_the_jax_package(name):
    rng = np.random.default_rng(0)
    speech = rng.standard_normal(4000).astype(np.float32) * 0.2
    other = rng.standard_normal(
        9000 if name == "noise_long" else 1500).astype(np.float32) * 0.1
    if name == "rir":
        rir = np.zeros(900, np.float32)
        rir[100], rir[250], rir[600] = 1.0, 0.3, -0.1
        got = taug.apply_impulse_response(speech, rir, sample_rate=8000)
        want = jaug.apply_impulse_response(speech, rir, sample_rate=8000)
    else:
        fn = "overlap_speech" if name == "overlap" else "add_background_noise"
        got = getattr(taug, fn)(np.random.default_rng(5), speech, other)
        want = getattr(jaug, fn)(np.random.default_rng(5), speech, other)
    assert got.dtype == want.dtype
    if name == "rir":
        # torch.fft and XLA's FFT round differently (f32 ulps)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_spec_augment_masks_as_jax_given_its_draws():
    B, T, F = 3, 120, 40
    feats = np.random.default_rng(1).standard_normal((B, T, F)).astype(
        np.float32)
    key = jax.random.PRNGKey(7)
    kw = dict(time_masks=5, time_width=0.1, freq_masks=2, freq_width=8)
    want = jaug.spec_augment(key, jnp.asarray(feats), mask_value=-1.5, **kw)

    # the JAX function's own draws (augment.py:spec_augment's key splits)
    kt, kf = jax.random.split(key)
    draws = []
    for k, length, width, n in ((kt, T, max(int(0.1 * T), 1), 5),
                                (kf, F, 8, 2)):
        ks, kw_ = jax.random.split(k)
        draws.append(jax.random.randint(ks, (B, n), 0, length))
        draws.append(jax.random.randint(kw_, (B, n), 0, width + 1))
    draws = taug.SpecDraws(*(torch.from_numpy(np.array(d)).long()
                             for d in draws))
    got = taug.apply_spec_masks(torch.from_numpy(feats), draws, -1.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    gen = torch.Generator().manual_seed(0)
    d = taug.spec_augment_draws(gen, 64, T, F, **kw)
    t_width = max(int(0.1 * T), 1)
    assert d.t_starts.shape == d.t_widths.shape == (64, 5)
    assert d.f_starts.shape == d.f_widths.shape == (64, 2)
    assert 0 <= d.t_starts.min() and d.t_starts.max() < T
    assert 0 <= d.f_starts.min() and d.f_starts.max() < F
    assert 0 <= d.t_widths.min() and d.t_widths.max() <= t_width
    assert 0 <= d.f_widths.min() and d.f_widths.max() <= 8
    assert d.t_widths.max() == t_width and d.f_widths.max() == 8
    out = taug.spec_augment(torch.Generator().manual_seed(0),
                            torch.from_numpy(feats), **kw)
    assert out.shape == feats.shape and (out == 0).any()


# ------------------------------------------------------------------ VAD

def _vad_batch():
    rng = np.random.default_rng(3)
    cfg = SileroConfig()
    waves = (rng.standard_normal((2, 3000)) * 0.005).astype(np.float32)
    waves[0, 600:1500] += np.sin(np.arange(900) * 0.2) * 0.4
    labels = tvad.window_labels(waves, cfg)
    return waves, labels


def test_vad_step_matches_jax():
    waves, labels = _vad_batch()
    mask = np.ones_like(labels)
    mask[1, -1] = 0.0
    jparams = j_init_silero(jax.random.PRNGKey(1), JSileroConfig())
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jvad.vad_loss_fn(p, JSileroConfig(), jnp.asarray(waves),
                                   jnp.asarray(labels), jnp.asarray(mask))))(
        jparams)
    tparams = to_torch(jparams)
    loss, grads = optim.value_and_grad(
        lambda p: tvad.vad_loss_fn(p, SileroConfig(), torch.from_numpy(waves),
                                   torch.from_numpy(labels),
                                   torch.from_numpy(mask)), tparams)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert_trees_rel_l2(grads, jgrads, 1e-4)


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_vad_step_keeps_the_stft_basis_in_the_optimizer(weight_decay):
    """The basis gets a zero gradient: adam leaves it; adamw still decays
    it, as optax does."""
    waves, labels = _vad_batch()
    cfg = tvad.VadTrainConfig(weight_decay=weight_decay)
    params = to_torch(j_init_silero(jax.random.PRNGKey(1), JSileroConfig()))
    opt = tvad.make_optimizer(cfg)
    new, _, loss = tvad.make_train_step(cfg, opt)(
        params, opt.init(params), torch.from_numpy(waves),
        torch.from_numpy(labels))
    basis, new_basis = params["stft_basis"], new["stft_basis"]
    if weight_decay:
        torch.testing.assert_close(new_basis, basis * (1 - 1e-3 * 0.1),
                                   rtol=1e-6, atol=1e-7)
    else:
        assert torch.equal(new_basis, basis)
    assert not torch.equal(new["lstm_wi"], params["lstm_wi"])


# ------------------------------------------------------------------ speaker

def test_speaker_step_matches_jax():
    rng = np.random.default_rng(6)
    jcfg, cfg = jspk.SpeakerTrainConfig.tiny(4), tspk.SpeakerTrainConfig.tiny(4)
    feats = rng.standard_normal((4, 50, 16)).astype(np.float32)
    lens = np.array([50, 41, 50, 33], np.int32)
    labels = np.array([0, 1, 2, 1], np.int32)
    jparams = jspk.init_speaker_params(jax.random.PRNGKey(0), jcfg)
    # the batch-statistics embedding itself
    want = jax.jit(lambda p, f, n: j_ecapa_embed(
        p, jcfg.ecapa, f, n, training=True))(
            jparams["ecapa"], jnp.asarray(feats), jnp.asarray(lens))
    tparams = to_torch(jparams)
    got = ecapa_embed(tparams["ecapa"], cfg.ecapa, torch.from_numpy(feats),
                      torch.from_numpy(lens), training=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)

    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jspk.speaker_loss_fn(p, jcfg, jnp.asarray(feats),
                                       jnp.asarray(lens),
                                       jnp.asarray(labels))))(jparams)
    loss, grads = optim.value_and_grad(
        lambda p: tspk.speaker_loss_fn(p, cfg, torch.from_numpy(feats),
                                       torch.from_numpy(lens),
                                       torch.from_numpy(labels)), tparams)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    # att_conv2's bias shifts every frame's attention logit of a channel
    # alike, and the softmax over time removes it: its gradient is 0
    assert_trees_rel_l2(grads, jgrads, 1e-4,
                        zero_in_exact_arithmetic=("/ecapa/att_conv2/b",))


# ------------------------------------------------------------------ CLIs

def test_vad_and_speaker_clis_on_the_cpu(tmp_path):
    m = noise_manifest(tmp_path, n=4, seconds=1.0, step=0.2,
                       extra=lambda i: {"label": f"spk{i % 2}"})
    out = tmp_path / "vad.npz"
    log = tvad.main(["--manifest", m, "--steps", "2", "--out", str(out),
                     "--device", "cpu"])
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    from asr_streaming_tpu_torch.utils.checkpoint import load_params
    assert "stft_basis" in load_params(str(out))["vad"]

    out = tmp_path / "ecapa.npz"
    log = tspk.main(["--manifest", m, "--steps", "2", "--batch-size", "2",
                     "--seconds", "0.5", "--tiny", "--save", str(out),
                     "--device", "cpu"])
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    from asr_streaming_tpu_torch.models.ecapa import (
        EcapaConfig, load_ecapa_weights,
    )
    load_ecapa_weights(str(out), EcapaConfig.tiny())
