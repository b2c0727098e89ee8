"""The port's log-mel frontend vs the JAX package's CPU conv spelling.

Tolerance rtol = atol = 1e-4: the port frames + matmuls where JAX's CPU
path runs a strided conv, so the 800-tap sums run in a different order.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asr_streaming_tpu.ops import frontend as jf
from asr_streaming_tpu_torch.ops import frontend as tf


def _wave(B, T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, T)) * 0.2).astype(np.float32)


@pytest.mark.parametrize("lang", ["vi", "en"])
def test_log_mel_matches_jax_conv_spelling(lang):
    jcfg = (jf.MelConfig.for_vietnamese() if lang == "vi"
            else jf.MelConfig.for_english())
    tcfg = (tf.MelConfig.for_vietnamese() if lang == "vi"
            else tf.MelConfig.for_english())
    wave = _wave(3, 13440 if lang == "vi" else 5120, seed=1)
    jp = jf.make_mel_params(jcfg)
    tp = tf.make_mel_params(tcfg, device="cpu")
    np.testing.assert_array_equal(tp["mel_fb"].numpy(),
                                  np.asarray(jp["mel_fb"]))
    np.testing.assert_array_equal(tp["dft_kernel"].numpy(),
                                  np.asarray(jp["dft_kernel"]))
    want = np.asarray(jf.log_mel(jp, jcfg, jnp.asarray(wave),
                                 fast_dft=False))
    got = tf.log_mel(tp, tcfg, torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (3, jcfg.num_frames(
        wave.shape[1] if lang == "vi" else wave.shape[1]), jcfg.n_mels)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_piecewise_log_with_global_stats(tmp_path):
    rng = np.random.default_rng(3)
    stats = {"mean": rng.standard_normal(80).tolist(),
             "invstddev": (rng.random(80) + 0.5).tolist()}
    path = tmp_path / "global_stats.json"
    path.write_text(json.dumps(stats))
    jcfg, tcfg = jf.MelConfig.for_english(), tf.MelConfig.for_english()
    jm, ji = jf.load_global_stats(str(path))
    tm, ti = tf.load_global_stats(str(path), device="cpu")
    wave = _wave(2, 2560, seed=4)
    want = np.asarray(jf.log_mel(jf.make_mel_params(jcfg), jcfg,
                                 jnp.asarray(wave), mean=jm, invstddev=ji,
                                 fast_dft=False))
    got = tf.log_mel(tf.make_mel_params(tcfg, device="cpu"), tcfg, torch.from_numpy(wave),
                     mean=tm, invstddev=ti).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
