"""The port's ASR step and offline path vs the JAX package, and the
overfit fixture's golden transcript through the port.

Log-prob tolerance 1e-4: the frontend sums its 800 DFT taps in another
order than JAX's CPU conv (tests/test_torch_frontend.py); argmax exact.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import asr as ja
from asr_streaming_tpu_torch.decode.greedy import greedy_search_full
from asr_streaming_tpu_torch.models import asr as ta
from asr_streaming_tpu_torch.models.encoder import encoder_forward
from asr_streaming_tpu_torch.ops.frontend import log_mel
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, params_from_numpy,
)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "test_fixtures", "overfit_ctc.npz")
VOCAB = ["-", "|", "a", "b", "c", "d"]
TONE_HZ = {"a": 350.0, "b": 700.0, "c": 1400.0, "d": 2100.0, " ": 1000.0}


def sentence_audio(s, total=2.56, lead=0.0, sr=16000):
    """The tone sentences of tests/test_overfit_e2e.py."""
    parts = [np.zeros(int(sr * lead), np.float32)]
    for ch in s:
        t = np.arange(int(sr * 0.24)) / sr
        wave = 0.3 * np.sin(2 * np.pi * TONE_HZ[ch] * t)
        ramp = np.minimum(1.0, np.arange(len(t)) / (0.010 * sr))
        parts.extend([(wave * ramp * ramp[::-1]).astype(np.float32),
                      np.zeros(int(sr * 0.08), np.float32)])
    audio = np.concatenate(parts)
    return np.pad(audio, (0, int(sr * total) - len(audio)))


def golden_and_params():
    with np.load(FIXTURE) as z:
        golden = json.loads(str(z["__meta__"]))["golden"]
    return golden, params_from_numpy(load_params(FIXTURE), "cpu")


@pytest.mark.parametrize("lead", [0.0, 0.2])
def test_overfit_offline_greedy_gives_golden(lead):
    golden, params = golden_and_params()
    assert golden == "ab cd"
    cfg = ta.ASRConfig.tiny(vocab_size=len(VOCAB))
    wave = torch.from_numpy(sentence_audio(golden, lead=lead))[None]
    feats = log_mel(params["frontend"], cfg.mel, wave)
    lp, _ = encoder_forward(params["encoder"], cfg.encoder, feats)
    text, _ = greedy_search_full(lp[0].numpy(), VOCAB)
    assert text.strip() == golden


def _random_tiny(seed):
    cfg_j = ja.ASRConfig.tiny(vocab_size=21)
    jparams = ja.init_asr_params(jax.random.PRNGKey(seed), cfg_j)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg_j, ta.ASRConfig.tiny(vocab_size=21), jparams, tparams


def test_stream_step_matches_jax():
    cfg_j, cfg_t, jparams, tparams = _random_tiny(0)
    rng = np.random.default_rng(0)
    B = 3
    jstate = ja.init_asr_state(cfg_j, B)
    tstate = ta.init_asr_state(cfg_t, B, device="cpu")
    for step in range(3):
        wave = (rng.standard_normal((B, cfg_t.audio.chunk_length))
                * 0.3).astype(np.float32)
        reset = rng.random(B) < 0.3
        advance = rng.random(B) < 0.8
        jo = ja.asr_stream_step(jparams, cfg_j, jnp.asarray(wave), jstate,
                                reset=jnp.asarray(reset),
                                advance=jnp.asarray(advance))
        to = ta.asr_stream_step(tparams, cfg_t, torch.from_numpy(wave),
                                tstate, reset=torch.from_numpy(reset),
                                advance=torch.from_numpy(advance))
        np.testing.assert_allclose(to.log_probs.numpy(),
                                   np.asarray(jo.log_probs), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {step}")
        np.testing.assert_array_equal(to.argmax.numpy(),
                                      np.asarray(jo.argmax))
        np.testing.assert_allclose(to.frame_max.numpy(),
                                   np.asarray(jo.frame_max), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(to.state.length.numpy(),
                                      np.asarray(jo.state.length))
        jstate, tstate = jo.state, to.state


def test_offline_logprobs_and_framing_match_jax():
    cfg_j, cfg_t, jparams, tparams = _random_tiny(1)
    wave = (np.random.default_rng(1).standard_normal(30000) * 0.2).astype(
        np.float32)
    fj = ja.frame_waveform(wave, cfg_j.audio)
    ft = ta.frame_waveform(wave, cfg_t.audio)
    np.testing.assert_array_equal(ft, fj)
    chunks = np.stack([ft, ft[::-1].copy()], axis=1)     # [n, B=2, chunk]
    want = np.asarray(ja.asr_offline_logprobs(jparams, cfg_j,
                                              jnp.asarray(chunks)))
    got = ta.asr_offline_logprobs(tparams, cfg_t,
                                  torch.from_numpy(chunks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
