"""The port's CTC serving tick vs the JAX package's, over 3 ticks.

Pack flags, lead/trail and argmax exact; carried state, audio context
and fetched emissions within 2e-5 (f32 compute).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import asr as ja
from asr_streaming_tpu.models import serving as js
from asr_streaming_tpu_torch.models import asr as ta
from asr_streaming_tpu_torch.models import serving as ts
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy


def _configs(encoding, silero):
    kw = dict(use_silero=silero, upload_encoding=encoding,
              max_emission_frames=64)
    return (js.ServingConfig(asr=ja.ASRConfig.tiny(vocab_size=21), **kw),
            ts.ServingConfig(asr=ta.ASRConfig.tiny(vocab_size=21), **kw))


def test_mulaw_host_encoder_is_the_same():
    x = (np.random.default_rng(0).standard_normal(5000) * 0.3).astype(
        np.float32)
    np.testing.assert_array_equal(ts.mulaw_encode_host(x),
                                  js.mulaw_encode_host(x))
    u8 = np.arange(256, dtype=np.uint8)
    np.testing.assert_allclose(ts._mulaw_decode(torch.from_numpy(u8)).numpy(),
                               np.asarray(js._mulaw_decode(jnp.asarray(u8))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("silero", [False, True], ids=["energy", "silero"])
@pytest.mark.parametrize("encoding", ["mulaw", "int16"])
def test_serving_step_matches_jax(encoding, silero):
    jcfg, tcfg = _configs(encoding, silero)
    B, seg_len = 4, jcfg.asr.audio.segment_length
    jparams = js.init_serving_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    step = jax.jit(js.serving_step, static_argnums=(1,))

    jstate = js.init_serving_state(jcfg, B)
    jctx = js.init_audio_context(jcfg, B)
    jbuf = js.init_emission_buffer(jcfg, B)
    tstate = ts.init_serving_state(tcfg, B, device="cpu")
    tctx = ts.init_audio_context(tcfg, B, device="cpu")
    tbuf = ts.init_emission_buffer(tcfg, B, device="cpu")

    rng = np.random.default_rng(4)
    levels = np.array([0.3, 0.0, 0.05, 0.3], np.float32)   # slot 1 silent
    lengths = np.zeros(B, np.int64)
    for tick in range(3):
        audio = (rng.standard_normal((B, seg_len)) * levels[:, None]).astype(
            np.float32)
        if encoding == "mulaw":
            seg = js.mulaw_encode_host(audio)
        else:
            seg = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
        contain = rng.random(B) < 0.3
        active = np.array([True, True, tick != 1, True])
        new_stream = np.full(B, tick == 0)
        reset = np.array([tick == 0, tick == 0, tick == 0, tick == 2])

        jo = step(jparams, jcfg, jnp.asarray(seg), jnp.asarray(contain),
                  jnp.asarray(active), jnp.asarray(new_stream),
                  jnp.asarray(reset), jstate, jctx, jbuf)
        to = ts.serving_step(tparams, tcfg, torch.from_numpy(seg),
                             torch.from_numpy(contain),
                             torch.from_numpy(active),
                             torch.from_numpy(new_stream),
                             torch.from_numpy(reset), tstate, tctx, tbuf)
        jp, tp = np.asarray(jo.pack), to.pack.numpy()
        assert tp.shape == jp.shape == (B, 5 + 16)
        np.testing.assert_array_equal(tp, jp, err_msg=f"pack tick {tick}")
        np.testing.assert_allclose(to.ctx.numpy(), np.asarray(jo.ctx),
                                   rtol=2e-5, atol=2e-5)
        for name in ("mem", "lc_k", "lc_v"):
            np.testing.assert_allclose(
                getattr(to.state, name).numpy(),
                np.asarray(getattr(jo.state, name)), rtol=2e-5, atol=2e-5,
                err_msg=f"{name} tick {tick}")
        np.testing.assert_array_equal(to.state.length.numpy(),
                                      np.asarray(jo.state.length))
        decoded = tp[:, js.PACK_DECODED] > 0.5
        lengths = np.where(reset, 0, lengths) + 16 * decoded
        jstate, jctx, jbuf = jo.state, jo.ctx, jo.emission
        tstate, tctx, tbuf = to.state, to.ctx, to.emission

    jfetch = js.make_emission_fetcher(jcfg)
    tfetch = ts.make_emission_fetcher(tcfg)
    for slot in range(B):
        if lengths[slot]:
            np.testing.assert_allclose(
                tfetch(tbuf, slot, int(lengths[slot])),
                jfetch(jbuf, slot, int(lengths[slot])), rtol=2e-5, atol=2e-5)


def test_entry_points_need_cuda_unless_cpu_is_named():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _configs("mulaw", False)
    for fn in (lambda: ts.init_serving_params(0, tcfg),
               lambda: ts.init_serving_state(tcfg, 2),
               lambda: ts.init_audio_context(tcfg, 2),
               lambda: ts.init_emission_buffer(tcfg, 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn()
    # "rnnt" is served since the English slice; it needs its RNNTConfig
    with pytest.raises(ValueError, match="needs ServingConfig.rnnt"):
        ts.make_serving_step(ts.ServingConfig(model_kind="rnnt"))
    with pytest.raises(ValueError, match="model_kind"):
        ts.make_serving_step(ts.ServingConfig(model_kind="ctc2"))
