"""The port's BEST-RQ (SSL) and TTS GAN trainers against the JAX
package's.

``span_mask`` equals the JAX ``reduce_window`` on the JAX Bernoulli
starts.  One SSL step (SSLConfig.tiny), one generator step and one
discriminator step (GANTrainConfig.tiny with narrow discriminators,
channels 4-32): the loss within 1e-5 relative and every leaf's gradient
within 1e-4 relative L2 of ``jax.value_and_grad`` with the JAX
function's own draws, on JAX-shaped parameter trees of seeded numpy
values (``numpy_tree``); the generator's gradients in float64 (its f32
gradient is ill-conditioned), its f32 loss against the JAX float64 one.
The tests run torch on one thread (``one_torch_thread``).  The CLIs run at ``--tiny --device cpu`` and
write ``.npz`` files the JAX package loads: the GAN's generator, loaded
into the JAX ``TTSModel``, gives the port's audio within 1e-5.  Without a
card the CLIs raise unless given ``--device cpu``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import discriminators as jd
from asr_streaming_tpu.models import tts as jt
from asr_streaming_tpu.train import gan as jgan
from asr_streaming_tpu.train import ssl as jssl
from asr_streaming_tpu.utils.checkpoint import load_params as j_load_params
from asr_streaming_tpu_torch.models.tts import TTSConfig, TTSModel
from asr_streaming_tpu_torch.train import gan as tgan
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train import ssl as tssl
from asr_streaming_tpu_torch.train.data import TTSBatch
from asr_streaming_tpu.models import blocks as jblocks
from asr_streaming_tpu.models import emformer as jemformer
from asr_streaming_tpu.models import offline as joffline
from asr_streaming_tpu.ops import istft as jistft
from asr_streaming_tpu.train import losses as jlosses
from tests.torch_train_common import (  # noqa: F401  (a fixture)
    assert_trees_rel_l2, jax_float64, numpy_tree, one_torch_thread,
    to_torch, write_wav, zero_grad_leaves,
)

JSSL = dataclasses.replace(jssl.SSLConfig.tiny(), mask_prob=0.1)
SSL = dataclasses.replace(tssl.SSLConfig.tiny(), mask_prob=0.1)
JGAN, GAN = jgan.GANTrainConfig.tiny(), tgan.GANTrainConfig.tiny()
NARROW = (4, 8, 16, 32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    return abs(float(got) - float(want)) / abs(float(want))


# ------------------------------------------------------------------- SSL

def _ssl_draws(key, shape):
    """The JAX loss's draws (ssl.py::ssl_loss_fn's key splits)."""
    k_mask, k_noise = jax.random.split(key)
    starts = jax.random.bernoulli(k_mask, JSSL.mask_prob, shape[:2])
    noise = jax.random.normal(k_noise, shape, jnp.float32)
    return tssl.SSLDraws(_t(starts), _t(noise))


def test_span_mask_matches_jax():
    key = jax.random.PRNGKey(0)
    lens = jnp.asarray([100, 50, 100, 10])
    want = jssl.span_mask(key, (4, 100), prob=0.05, span=8, lens=lens)
    starts = jax.random.bernoulli(key, 0.05, (4, 100))
    got = tssl.span_mask(_t(starts), 8, _t(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got[1, 50:].any() and not got[3, 10:].any()
    own = tssl.ssl_draws(torch.Generator().manual_seed(0), SSL, (4, 100, 16))
    assert own.starts.dtype == torch.bool and own.noise.shape == (4, 100, 16)


def test_ssl_step_matches_jax():
    trainable, frozen = numpy_tree(lambda k: jssl.init_ssl_params(k, JSSL), 1)
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((2, 64, 16)).astype(np.float32)
    lens = np.array([64, 45], np.int32)
    key = jax.random.PRNGKey(3)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda t, f, x, n, k: jssl.ssl_loss_fn(t, f, JSSL, x, n, k)))(
        trainable, frozen, jnp.asarray(feats), jnp.asarray(lens), key)
    draws = _ssl_draws(key, feats.shape)
    tfrozen = to_torch(frozen)
    got_loss, got_grads = optim.value_and_grad(
        lambda t: tssl.ssl_loss_fn(t, tfrozen, SSL, _t(feats), _t(lens),
                                   draws), to_torch(trainable))
    assert float(loss) > 0
    assert _rel(got_loss, loss) <= 1e-5, (float(got_loss), float(loss))
    assert_trees_rel_l2(got_grads, grads, 1e-4,
                        zero_in_exact_arithmetic=zero_grad_leaves(grads))


def test_ssl_cli_writes_the_jax_layout(tmp_path):
    rng = np.random.default_rng(0)
    entries = []
    for i in range(3):
        p = tmp_path / f"a{i}.wav"
        write_wav(p, rng.standard_normal(16000) * 0.09)
        entries.append(json.dumps({"audio_filepath": str(p),
                                   "duration": 1.0}))
    manifest = tmp_path / "ssl.jsonl"
    manifest.write_text("\n".join(entries))
    args = ["--manifest", str(manifest), "--steps", "2", "--batch-size",
            "2", "--seconds", "1.0", "--tiny", "--save",
            str(tmp_path / "ssl.npz")]
    log_ = tssl.main(args + ["--device", "cpu"])
    assert len(log_.losses) == 2 and np.isfinite(log_.losses).all()
    like = jax.eval_shape(lambda k: dict(zip(
        ("trainable", "frozen"), jssl.init_ssl_params(k, JSSL))),
        jax.random.PRNGKey(0))
    loaded = j_load_params(str(tmp_path / "ssl.npz"), like=like)
    assert jax.tree.structure(loaded) == jax.tree.structure(like)


# ------------------------------------------------------------------- GAN

def _tts_batch(B=2, Tp=12, seed=0) -> TTSBatch:
    """tests/test_ssl_gan_train.py's batch: 4 words of 3 tokens."""
    rng = np.random.default_rng(seed)
    tts = JGAN.tts
    tokens = rng.integers(1, tts.linguistic.vocab_size, (B, Tp)).astype(
        np.int32)
    word_idxs = np.repeat(np.arange(Tp // 3), 3)[None].repeat(B, 0) \
        .astype(np.int32)
    word_durs = np.zeros((B, Tp), np.int32)
    word_durs[:, :Tp // 3] = rng.integers(8, 16, (B, Tp // 3))
    audio = np.zeros((B, tts.max_frames * tts.hop_length), np.float32)
    audio_lens = (word_durs.sum(1) * tts.hop_length).astype(np.int32)
    for b in range(B):
        audio[b, :audio_lens[b]] = \
            rng.standard_normal(audio_lens[b]).astype(np.float32) * 0.1
    return TTSBatch(tokens, np.full(B, Tp, np.int32), word_idxs, word_durs,
                    audio, audio_lens)


@pytest.fixture(scope="module")
def gan():
    """Generator and narrow discriminators (JAX trees), the batch, and the
    JAX generator step's loss, aux and gradients in float64."""
    gen = numpy_tree(lambda k: jt.init_tts_params(k, JGAN.tts), 2)
    disc = {
        "mpd": {"discs": [numpy_tree(lambda k: jd.init_period_discriminator(
            k, NARROW), 10 + i) for i in range(len(jd.PERIODS))]},
        "mrd": {"discs": [numpy_tree(
            lambda k: jd.init_resolution_discriminator(k, NARROW), 20 + i)
            for i in range(len(jd.RESOLUTIONS))]},
    }
    static = {"periods": list(jd.PERIODS),
              "resolutions": [tuple(r) for r in jd.RESOLUTIONS]}
    batch = _tts_batch()
    wide = [jax.tree.map(lambda a: np.asarray(a, np.float64), t)
            for t in (gen, disc)]
    batch64 = batch._replace(audio=batch.audio.astype(np.float64))
    with jax_float64(jemformer, jblocks, joffline, jistft, jlosses, jgan):
        (loss, aux), grads = jax.jit(jax.value_and_grad(
            lambda g, d, b: jgan.gen_loss_fn(g, d, static, JGAN, b),
            has_aux=True))(*jax.tree.map(jnp.asarray, wide),
                           TTSBatch(*map(jnp.asarray, batch64)))
        assert grads["decoder"]["out_conv"]["w"].dtype == jnp.float64
    aux = jax.tree.map(np.asarray, aux)
    return gen, disc, static, batch, wide, batch64, loss, aux, grads


def test_gan_generator_step_matches_jax(gan):
    """The loss, its parts and the fake audio in f32 within 1e-5 of the
    JAX function's float64 values; the gradients in float64 (both
    packages) within 1e-4 relative L2.  The generator's f32 gradient is
    ill-conditioned at this geometry: two f32 runs of the same code
    differ by far more than 1e-4 on the decoder attention's leaves
    (3.9e-3 relative L2 between the port on an NVIDIA H100 and on the
    CPU, chip_smoke.py phase 13 (a)), so f32 implementations that sum in
    another order cannot be held to 1e-4 there; in float64 they agree
    far below it."""
    gen, disc, static, batch, wide, batch64, loss, aux, grads = gan
    got_loss, got_aux = tgan.gen_loss_fn(
        to_torch(gen), to_torch(disc), static, GAN,
        tgan.tts_batch_to(batch, "cpu"))
    assert got_loss.dtype == torch.float32
    assert _rel(got_loss, loss) <= 1e-5, (float(got_loss), float(loss))
    for k in ("stft", "adv", "dur"):
        assert _rel(got_aux[k], aux[k]) <= 1e-5, k
    np.testing.assert_allclose(got_aux["fake"].detach().numpy(), aux["fake"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got_aux["real"].numpy(), aux["real"])

    (got64, _), got_grads = optim.value_and_grad(
        lambda g: tgan.gen_loss_fn(
            g, to_torch(wide[1]), static, GAN,
            tgan.tts_batch_to(batch64, "cpu")), to_torch(wide[0]),
        has_aux=True)
    assert got64.dtype == torch.float64
    assert _rel(got64, loss) <= 1e-5, (float(got64), float(loss))
    assert_trees_rel_l2(got_grads, grads, 1e-4,
                        zero_in_exact_arithmetic=zero_grad_leaves(grads))


def test_gan_discriminator_step_matches_jax(gan):
    _, disc, static, *_, aux, _ = gan
    fake = aux["fake"].astype(np.float32)
    real = aux["real"].astype(np.float32)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda d, f, r: jgan.disc_loss_fn(d, static, f, r)))(
        disc, jnp.asarray(fake), jnp.asarray(real))
    got_loss, got_grads = optim.value_and_grad(
        lambda d: tgan.disc_loss_fn(d, static, _t(fake), _t(real)),
        to_torch(disc))
    assert _rel(got_loss, loss) <= 1e-5, (float(got_loss), float(loss))
    # the MRD's output bias is not used (models/discriminators.py): both
    # gradients are zero there, which the comparison requires
    assert not np.any(np.asarray(grads["mrd"]["discs"][0]["out"]["b"]))
    assert_trees_rel_l2(got_grads, grads, 1e-4)


def test_gan_steps_update_and_hand_the_fake_over_detached(gan):
    gen, disc, static, batch, *_ = gan
    gen_opt = optim.adamw(2e-4, b1=0.8, b2=0.99)
    disc_opt = optim.adamw(2e-4, b1=0.8, b2=0.99)
    gen_step, disc_step = tgan.make_gan_train_steps(GAN, gen_opt, disc_opt,
                                                    static)
    tgen, tdisc = to_torch(gen), to_torch(disc)
    new_gen, _, metrics, fake, real = gen_step(
        tgen, tdisc, gen_opt.init(tgen), tgan.tts_batch_to(batch, "cpu"))
    assert fake.grad_fn is None and not fake.requires_grad
    assert fake.shape == real.shape
    new_disc, _, d_loss = disc_step(tdisc, disc_opt.init(tdisc), fake, real)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert np.isfinite(float(d_loss))
    for old, new in ((tgen, new_gen), (tdisc, new_disc)):
        assert any(not torch.equal(a, b) for a, b in
                   zip(optim.tree_leaves(old), optim.tree_leaves(new)))


def test_gan_cli_checkpoint_loads_into_the_jax_tts_model(tmp_path,
                                                         monkeypatch):
    cfg = GAN.tts
    rng = np.random.default_rng(0)
    entries = []
    for i in range(2):
        p = tmp_path / f"t{i}.wav"
        write_wav(p, rng.standard_normal(cfg.max_frames * cfg.hop_length // 2)
                  * 0.09)
        entries.append(json.dumps({
            "audio_filepath": str(p),
            "tokens": rng.integers(1, cfg.linguistic.vocab_size, 9).tolist(),
            "word_idxs": [0, 0, 0, 1, 1, 1, 2, 2, 2],
            "word_durations": rng.integers(8, 16, 3).tolist()}))
    manifest = tmp_path / "tts.jsonl"
    manifest.write_text("\n".join(entries))
    save = str(tmp_path / "tts.npz")
    log_ = tgan.main(["--manifest", str(manifest), "--steps", "2",
                      "--batch-size", "1", "--tiny", "--save", save,
                      "--device", "cpu"])
    assert len(log_.losses) == 2 and np.isfinite(log_.losses).all()

    tokens = np.array([1, 2, 3, 4, 5, 6, 7], np.int32)
    words = np.array([0, 0, 1, 1, 2, 2, 2], np.int32)
    got = TTSModel(TTSConfig.tiny(), checkpoint=save, device="cpu")(tokens,
                                                                   words)
    # the checkpoint replaces every leaf, so the JAX model's seeded init
    # (many small jax.random compiles) is replaced by a tree of its shape
    init = jt.init_tts_params
    monkeypatch.setattr(jt, "init_tts_params", lambda key, c: numpy_tree(
        lambda k: init(k, c), 0))
    model = jt.TTSModel(jt.TTSConfig.tiny(), checkpoint=save)
    # the JAX TTSModel keeps load_params' numpy leaves, and its jitted
    # synthesize cannot index a numpy embedding with a traced array
    # (TracerArrayConversionError): as device arrays they synthesize
    model.params = jax.tree.map(jnp.asarray, model.params)
    want = model(tokens, words)
    assert got.shape == want.shape and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cli", ["ssl", "gan"])
def test_clis_raise_without_a_card_unless_given_cpu(cli, monkeypatch,
                                                    tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = {"ssl": tssl, "gan": tgan}[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--manifest", str(tmp_path / "none.jsonl")])
