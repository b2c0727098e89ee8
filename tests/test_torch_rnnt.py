"""The port's Emformer-RNNT components and greedy chunk step vs the JAX
package's, on the same numpy inputs and the same weights.

Weights are made by the JAX init and carried over with
``params_from_numpy``.  Float outputs: rtol = atol = 2e-5 in f32 (the JAX
package's tolerance for its own kernels; only summation order differs).
Integer outputs (tokens, counts, last_token) are exact.  The Emformer
inside the transcriber runs its stack route, which on the CPU is the
kernel's plain version.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import rnnt as jr
from asr_streaming_tpu_torch.models import rnnt as tr
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(seed=0, vocab=32):
    jcfg = jr.RNNTConfig.tiny(vocab_size=vocab)
    tcfg = tr.RNNTConfig.tiny(vocab_size=vocab)
    jparams = jr.init_rnnt_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _close(got: torch.Tensor, want, **kw):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(kw or TOL))


def _feats(rng, cfg, B):
    em = cfg.emformer
    T = (em.segment_length + em.right_context_length) * 4
    return rng.standard_normal((B, T, cfg.n_mels)).astype(np.float32)


def test_config_and_init_match_the_jax_tree():
    jcfg, tcfg, jparams, _ = _setup()
    for f in ("n_mels", "d_model", "encoding_dim", "vocab_size", "blank",
              "pred_layers", "pred_hidden", "max_symbols_per_frame",
              "lstm_ln_eps"):
        assert getattr(tr.RNNTConfig(), f) == getattr(jr.RNNTConfig(), f), f
    mine = tr.init_rnnt_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    want = jax.tree.map(np.shape, jparams)
    got = jax.tree.map(lambda t: tuple(t.shape), mine)
    assert got == want
    em = tr.RNNTConfig().emformer
    assert (em.segment_length, em.right_context_length,
            em.left_context_length, em.max_memory_size) == (4, 1, 30, 0)

    class Audio:
        segment_size = 8
    assert tr.transcriber_segment_frames(Audio) == 2
    assert tr.rnnt_config_for_audio(tcfg, Audio).emformer.segment_length == 2


def test_transcriber_step_matches_jax_over_chained_chunks():
    jcfg, tcfg, jparams, tparams = _setup(seed=1)
    rng = np.random.default_rng(0)
    B = 3
    jstate = jr.init_rnnt_state(jcfg, B).encoder
    tstate = tr.init_rnnt_state(tcfg, B, "cpu").encoder
    for _ in range(3):       # the left context fills over the chunks
        feats = _feats(rng, jcfg, B)
        jenc, jstate = jr.transcriber_step(jparams, jcfg, jnp.asarray(feats),
                                           jstate)
        tenc, tstate = tr.transcriber_step(tparams, tcfg,
                                           torch.from_numpy(feats), tstate)
        assert tuple(tenc.shape) == (B, 4, tcfg.encoding_dim)
        _close(tenc, jenc)
        _close(tstate.lc_k, jstate.lc_k)
        _close(tstate.lc_v, jstate.lc_v)
        assert tstate.length.tolist() == np.asarray(jstate.length).tolist()


@pytest.mark.parametrize("with_cfg", [True, False], ids=["cfg", "cfg_none"])
@pytest.mark.parametrize("layers", [1, 3])
def test_predictor_step_and_joiner_match_jax(layers, with_cfg):
    import dataclasses
    # stacked LSTM params need one input width: embed dim == hidden
    kw = dict(pred_layers=layers, pred_embed_dim=32)
    jcfg = dataclasses.replace(jr.RNNTConfig.tiny(), **kw)
    tcfg = dataclasses.replace(tr.RNNTConfig.tiny(), **kw)
    jparams = jr.init_rnnt_params(jax.random.PRNGKey(2), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rng = np.random.default_rng(1)
    B = 5
    tokens = rng.integers(0, jcfg.vocab_size, B).astype(np.int32)
    h = rng.standard_normal((layers, B, jcfg.pred_hidden)).astype(np.float32)
    c = rng.standard_normal((layers, B, jcfg.pred_hidden)).astype(np.float32)
    jout, jst = jr.predictor_step(
        jparams, jnp.asarray(tokens),
        jr.PredictorState(jnp.asarray(h), jnp.asarray(c)),
        jcfg if with_cfg else None)
    tout, tst = tr.predictor_step(
        tparams, torch.from_numpy(tokens),
        tr.PredictorState(torch.from_numpy(h), torch.from_numpy(c)),
        tcfg if with_cfg else None)
    _close(tout, jout)
    _close(tst.h, jst.h)
    _close(tst.c, jst.c)
    enc = rng.standard_normal((B, jcfg.encoding_dim)).astype(np.float32)
    _close(tr.joiner(tparams, torch.from_numpy(enc), tout),
           jr.joiner(jparams, jnp.asarray(enc), jout))


def test_greedy_stream_step_tokens_exact_over_chunks():
    """Five chunks, the third with slot 1 inactive: tokens, n_emitted and
    last_token exact, float state at the tolerance, inactive slot held."""
    jcfg, tcfg, jparams, tparams = _setup(seed=3)
    rng = np.random.default_rng(2)
    B = 3
    jstate = jr.init_rnnt_state(jcfg, B)
    tstate = tr.init_rnnt_state(tcfg, B, "cpu")
    jstep = jax.jit(lambda p, f, s, a: jr.rnnt_greedy_stream_step(
        p, jcfg, f, s, active=a))
    emitted = 0
    for chunk in range(5):
        feats = _feats(rng, jcfg, B) * 2.0
        active = np.array([True, chunk != 2, True])
        before = tstate
        jout = jstep(jparams, jnp.asarray(feats), jstate, jnp.asarray(active))
        tout = tr.rnnt_greedy_stream_step(
            tparams, tcfg, torch.from_numpy(feats), tstate,
            active=torch.from_numpy(active))
        jstate, tstate = jout.state, tout.state
        assert tout.tokens.dtype == torch.int32
        assert tuple(tout.tokens.shape) == (B, 4 * tcfg.max_symbols_per_frame)
        np.testing.assert_array_equal(tout.tokens.numpy(),
                                      np.asarray(jout.tokens))
        np.testing.assert_array_equal(tout.n_emitted.numpy(),
                                      np.asarray(jout.n_emitted))
        np.testing.assert_array_equal(tstate.last_token.numpy(),
                                      np.asarray(jstate.last_token))
        _close(tout.encodings, jout.encodings)
        _close(tstate.predictor.h, jstate.predictor.h)
        _close(tstate.predictor.c, jstate.predictor.c)
        _close(tstate.encoder.lc_k, jstate.encoder.lc_k)
        assert tstate.encoder.length.tolist() == \
            np.asarray(jstate.encoder.length).tolist()
        emitted += int(tout.n_emitted.sum())
        if chunk == 2:
            assert int(tout.n_emitted[1]) == 0
            for new, old in zip(
                    (*tstate.encoder, *tstate.predictor, tstate.last_token),
                    (*before.encoder, *before.predictor, before.last_token)):
                ax = 0 if new.ndim == 1 else 1
                assert torch.equal(new.select(ax, 1), old.select(ax, 1))
    assert emitted > 0, "random weights emitted nothing: the test is vacuous"


def test_greedy_without_active_mask_equals_all_active():
    _, tcfg, _, tparams = _setup(seed=4)
    feats = torch.from_numpy(_feats(np.random.default_rng(3), tcfg, 2))
    state = tr.init_rnnt_state(tcfg, 2, "cpu")
    a = tr.rnnt_greedy_stream_step(tparams, tcfg, feats, state)
    b = tr.rnnt_greedy_stream_step(tparams, tcfg, feats, state,
                                   active=torch.ones(2, dtype=torch.bool))
    assert torch.equal(a.tokens, b.tokens)
    assert torch.equal(a.state.predictor.h, b.state.predictor.h)


def test_detokenize_pieces():
    pieces = ["▁a", "▁b", "c", "<b>"]
    assert tr.detokenize_pieces([0, 2, 1, 9], pieces) == \
        jr.detokenize_pieces([0, 2, 1, 9], pieces) == " ac b"
    assert tr.detokenize_pieces([0, 1], pieces, lstrip=True) == "a b"


def test_rnnt_fixture_checkpoint_loads_unchanged(tmp_path):
    """The JAX package's RNNT ``.npz`` (stacked ``predictor::lstm::*``
    leaves and all) loads into the port's tree, by template and as an
    overlay, and round-trips through the port's writer."""
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, overlay_params, save_params,
    )
    from tests.fixture_assets import asset_path
    path = asset_path("overfit_rnnt")
    cfg = tr.RNNTConfig.tiny(vocab_size=5)
    like = tr.init_rnnt_params(torch.Generator().manual_seed(0), cfg, "cpu")
    loaded = load_params(path, like=like)
    raw = load_params(path)
    assert set(raw) == {"input_linear", "emformer", "enc_out", "predictor",
                        "joiner"}
    over = overlay_params(like, raw)
    wi = loaded["predictor"]["lstm"]["wi"]
    assert tuple(wi.shape) == (1, 24, 128) and isinstance(wi, torch.Tensor)
    np.testing.assert_array_equal(wi.numpy(), raw["predictor"]["lstm"]["wi"])
    assert torch.equal(over["joiner"]["w"], loaded["joiner"]["w"])
    out = str(tmp_path / "rnnt.npz")
    save_params(out, loaded)
    again = load_params(out, like=like)
    assert torch.equal(again["emformer"]["w_q"], loaded["emformer"]["w_q"])
