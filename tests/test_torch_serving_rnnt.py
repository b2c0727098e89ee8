"""The port's English serving ticks (greedy and device beam) vs the JAX
package's, over chained ticks with reset, hold and a silent slot.

Pack flags and token columns (greedy tokens; the beam's count and token
buffer) are exact; lead/trail, the audio context and the carried float
state within rtol = atol = 2e-5 (f32 compute).  The encoding buffer is
float16 in both (the JAX package packs f16 pairs into f32 words): values
2e-5 apart can round to neighbouring f16 values, so it is held to
rtol 2e-3 (two f16 steps), atol 2e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import asr as ja
from asr_streaming_tpu.models import rnnt as jr
from asr_streaming_tpu.models import serving as js
from asr_streaming_tpu.utils.audio import EN_AUDIO as J_EN_AUDIO
from asr_streaming_tpu_torch.models import asr as ta
from asr_streaming_tpu_torch.models import rnnt as tr
from asr_streaming_tpu_torch.models import serving as ts
from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)
VOCAB = 32


def _configs(beam_width, encoding="int16"):
    kw = dict(model_kind="rnnt", use_silero=False, upload_encoding=encoding,
              max_emission_frames=32, en_beam_width_device=beam_width,
              en_beam_cap=24)
    jcfg = js.ServingConfig(
        asr=dataclasses.replace(ja.ASRConfig.tiny(), audio=J_EN_AUDIO),
        rnnt=jr.RNNTConfig.tiny(vocab_size=VOCAB), **kw)
    tcfg = ts.ServingConfig(
        asr=dataclasses.replace(ta.ASRConfig.tiny(), audio=EN_AUDIO),
        rnnt=tr.RNNTConfig.tiny(vocab_size=VOCAB), **kw)
    return jcfg, tcfg


def _state_leaves(state):
    """(name, tensor) of every carried leaf, the same order both sides."""
    enc = state.encoder
    out = [("lc_k", enc.lc_k), ("lc_v", enc.lc_v), ("length", enc.length)]
    rest = state.beam if hasattr(state, "beam") else None
    if rest is None:
        out += [("pred_h", state.predictor.h), ("pred_c", state.predictor.c),
                ("last_token", state.last_token)]
    else:
        out += [(n, getattr(rest, n)) for n in rest._fields]
    return out


@pytest.mark.parametrize("beam_width,encoding", [
    (None, "int16"), (None, "mulaw"), (2, "int16"), (4, "int16"),
    (4, "mulaw")], ids=["greedy-int16", "greedy-mulaw", "beam2-int16",
                        "beam4-int16", "beam4-mulaw"])
def test_rnnt_serving_ticks_match_jax(beam_width, encoding):
    jcfg, tcfg = _configs(beam_width, encoding)
    assert ts.make_serving_step(tcfg) is (
        ts.serving_step_rnnt_beam if beam_width else ts.serving_step_rnnt)
    assert ts.emission_width(tcfg) == js.emission_width(jcfg) == 48
    B, seg_len = 4, EN_AUDIO.segment_length
    jparams = js.init_serving_params(jax.random.PRNGKey(3), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    mine = ts.init_serving_params(0, tcfg, "cpu")
    assert jax.tree.map(np.shape, jparams) == \
        jax.tree.map(lambda t: tuple(t.shape), mine)
    jstep = jax.jit(js.make_serving_step(jcfg), static_argnums=(1,))
    tstep = ts.make_serving_step(tcfg)

    jstate = js.init_serving_state(jcfg, B)
    jctx = js.init_audio_context(jcfg, B)
    jbuf = js.init_emission_buffer(jcfg, B)
    tstate = ts.init_serving_state(tcfg, B, device="cpu")
    tctx = ts.init_audio_context(tcfg, B, device="cpu")
    tbuf = ts.init_emission_buffer(tcfg, B, device="cpu")
    assert tbuf.dtype == torch.float16 and tuple(tbuf.shape) == (B, 32, 48)

    rng = np.random.default_rng(4)
    levels = np.array([0.3, 0.0, 0.05, 0.3], np.float32)   # slot 1 silent
    lengths = np.zeros(B, np.int64)
    n_ticks, any_token = 6, False
    for tick in range(n_ticks):
        audio = (rng.standard_normal((B, seg_len)) * levels[:, None]).astype(
            np.float32)
        if encoding == "mulaw":
            seg = js.mulaw_encode_host(audio)
        else:
            seg = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
        contain = rng.random(B) < 0.3
        active = np.array([True, True, tick != 2, True])
        new_stream = np.full(B, tick == 0)
        reset = np.array([tick == 0, tick == 0, tick == 0, tick in (0, 3)])
        flags = (contain, active, new_stream, reset)
        jo = jstep(jparams, jcfg, jnp.asarray(seg),
                   *(jnp.asarray(f) for f in flags), jstate, jctx, jbuf)
        to = tstep(tparams, tcfg, torch.from_numpy(seg),
                   *(torch.from_numpy(f) for f in flags), tstate, tctx, tbuf)
        jp, tp = np.asarray(jo.pack), to.pack.numpy()
        width = 5 + (1 + 24 if beam_width else 4 * 4)
        assert tp.shape == jp.shape == (B, width)
        # flags and token columns exact; lead / trail are float seconds
        np.testing.assert_array_equal(tp[:, :3], jp[:, :3],
                                      err_msg=f"flags tick {tick}")
        np.testing.assert_array_equal(tp[:, 5:], jp[:, 5:],
                                      err_msg=f"tokens tick {tick}")
        np.testing.assert_allclose(tp[:, 3:5], jp[:, 3:5], **TOL)
        np.testing.assert_allclose(to.ctx.numpy(), np.asarray(jo.ctx), **TOL)
        for (name, t), (_, j) in zip(_state_leaves(to.state),
                                     _state_leaves(jo.state)):
            if t.dtype == torch.int32:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                              err_msg=f"{name} tick {tick}")
            else:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           err_msg=f"{name} tick {tick}",
                                           **TOL)
        decoded = tp[:, js.PACK_DECODED] > 0.5
        assert not decoded[1] or contain[1]         # the silent slot gates
        lengths = np.where(reset, 0, lengths) + 4 * decoded
        data = tp[:, 5:]
        any_token = any_token or bool(
            (data[:, 0] > 0).any() if beam_width
            else (data != tcfg.rnnt.blank).any())
        jstate, jctx, jbuf = jo.state, jo.ctx, jo.emission
        tstate, tctx, tbuf = to.state, to.ctx, to.emission
    assert any_token, "no token in any tick: the comparison is vacuous"

    jfetch = js.make_emission_fetcher(jcfg)
    tfetch = ts.make_emission_fetcher(tcfg)
    assert lengths.max() > 0
    for slot in range(B):
        if lengths[slot]:
            got = tfetch(tbuf, slot, int(lengths[slot]))
            assert got.shape == (lengths[slot], 48)
            np.testing.assert_allclose(
                got, jfetch(jbuf, slot, int(lengths[slot])), rtol=2e-3,
                atol=2e-5)


def test_tick_without_an_encoding_buffer():
    _, tcfg = _configs(None)
    params = ts.init_serving_params(0, tcfg, "cpu")
    B = 2
    on = torch.ones(B, dtype=torch.bool)
    seg = torch.randint(-3000, 3000, (B, EN_AUDIO.segment_length),
                        generator=torch.Generator().manual_seed(0),
                        dtype=torch.int16)
    out = ts.serving_step_rnnt(
        params, tcfg, seg, on, on, on, on,
        ts.init_serving_state(tcfg, B, "cpu"),
        ts.init_audio_context(tcfg, B, "cpu"))
    assert out.emission is None and tuple(out.pack.shape) == (B, 5 + 16)


def test_global_stats_reach_the_featurizer(tmp_path):
    import json
    _, tcfg = _configs(None)
    path = tmp_path / "stats.json"
    n = tcfg.rnnt.n_mels
    path.write_text(json.dumps({"mean": [0.5] * n, "invstddev": [2.0] * n}))
    cfg = dataclasses.replace(tcfg, en_global_stats=str(path))
    plain = ts.init_serving_params(0, tcfg, "cpu")
    params = ts.init_serving_params(0, cfg, "cpu")
    assert "mean" not in plain["en_frontend"]
    wave = torch.randn((2, EN_AUDIO.chunk_length),
                       generator=torch.Generator().manual_seed(1)) * 0.1
    a = ts._rnnt_feats(plain, tcfg, wave)
    b = ts._rnnt_feats(params, cfg, wave)
    assert tuple(a.shape) == (2, 20, n)
    torch.testing.assert_close(b, (a - 0.5) * 2.0)
