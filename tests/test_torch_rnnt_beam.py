"""The port's device-batched RNNT beam vs the JAX package's, and vs the
port's own host oracle.

Same weights (JAX init carried over with ``params_from_numpy``) and the
same numpy encodings go through both ``rnnt_beam_chunk_step``s: token
buffers, lengths and both hash lanes are exact, scores rtol = atol = 2e-5
(f32, summation order only), across a reset and under an ``active`` mask.
Then, as tests/test_rnnt_beam_device.py does for the JAX pair, the port's
beam against the port's ``RNNTBeamDecoder`` chunk by chunk.  Random
encodings at scale 1 leave no exact log-prob ties at the preselect
boundary, the one input where the oracle's argpartition is arbitrary.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import rnnt as jr
from asr_streaming_tpu.models import rnnt_beam as jb
from asr_streaming_tpu_torch.models import rnnt as tr
from asr_streaming_tpu_torch.models import rnnt_beam as tb
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy

TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(seed=0, vocab=32):
    jcfg = jr.RNNTConfig.tiny(vocab_size=vocab)
    tcfg = tr.RNNTConfig.tiny(vocab_size=vocab)
    jparams = jr.init_rnnt_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams


def _encodings(seed, cfg, B, chunks, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(
        (B, chunks, 4, cfg.encoding_dim)) * scale).astype(np.float32)


def _assert_states_match(t: tb.BeamState, j: jb.BeamState, where):
    for name in ("tokens", "lengths", "h1", "h2"):
        got, want = getattr(t, name), np.asarray(getattr(j, name))
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{name} {where}")
    for name in ("scores", "pred_h", "pred_c", "pred_out"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)),
                                   err_msg=f"{name} {where}", **TOL)


@pytest.mark.parametrize("width", [2, 4])
def test_beam_chunk_step_matches_jax_across_reset_and_hold(width):
    jcfg, tcfg, jparams, tparams = _setup(seed=0)
    B, chunks, cap = 3, 5, 32
    enc = _encodings(1, jcfg, B, chunks)
    jstate = jb.init_beam_state(jcfg, B, width, cap=cap)
    tstate = tb.init_beam_state(tcfg, B, width, cap=cap, device="cpu")
    _assert_states_match(tstate, jstate, "init")
    jstep = jax.jit(lambda p, e, s, a, r: jb.rnnt_beam_chunk_step(
        p, jcfg, e, s, active=a, reset=r))
    # chunk 0: all reset; chunk 2: stream 0 restarts; chunk 3: stream 1 held
    resets = [[1, 1, 1], [0, 0, 0], [1, 0, 0], [0, 0, 0], [0, 0, 0]]
    actives = [[1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 0, 1], [1, 1, 1]]
    grew = False
    for c in range(chunks):
        r, a = np.array(resets[c], bool), np.array(actives[c], bool)
        before = tstate
        jstate, jtoks, jlen = jstep(jparams, jnp.asarray(enc[:, c]), jstate,
                                    jnp.asarray(a), jnp.asarray(r))
        tstate, ttoks, tlen = tb.rnnt_beam_chunk_step(
            tparams, tcfg, torch.from_numpy(enc[:, c]), tstate,
            active=torch.from_numpy(a), reset=torch.from_numpy(r))
        _assert_states_match(tstate, jstate, f"chunk {c}")
        np.testing.assert_array_equal(ttoks.numpy(), np.asarray(jtoks))
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        grew = grew or int(tlen.max()) > 0
        if c == 3:      # the held stream's beam is bit for bit the old one
            for name, new, old in zip(tstate._fields, tstate, before):
                ax = 1 if name in ("pred_h", "pred_c") else 0
                assert torch.equal(new.select(ax, 1), old.select(ax, 1)), name
    assert grew, "no hypothesis ever held a token: the test is vacuous"


def test_without_masks_equals_all_active_no_reset():
    _, tcfg, _, tparams = _setup(seed=5)
    enc = torch.from_numpy(_encodings(6, tcfg, 2, 2))
    state = tb.init_beam_state(tcfg, 2, 3, cap=16, device="cpu")
    state, _, _ = tb.rnnt_beam_chunk_step(
        tparams, tcfg, enc[:, 0], state, reset=torch.ones(2, dtype=torch.bool))
    a, ta, la = tb.rnnt_beam_chunk_step(tparams, tcfg, enc[:, 1], state)
    b, tb_, lb = tb.rnnt_beam_chunk_step(
        tparams, tcfg, enc[:, 1], state,
        active=torch.ones(2, dtype=torch.bool),
        reset=torch.zeros(2, dtype=torch.bool))
    assert torch.equal(ta, tb_) and torch.equal(la, lb)
    assert torch.equal(a.scores, b.scores)


def _device_valid(state, b):
    """(token tuple, score) per live beam slot of stream b."""
    out = []
    for w in range(state.scores.shape[1]):
        sc = float(state.scores[b, w])
        if sc > tb.VALID_FLOOR:
            n = int(state.lengths[b, w])
            out.append((tuple(int(t) for t in state.tokens[b, w, :n]), sc))
    return out


@pytest.mark.parametrize("width", [1, 4])
def test_device_beam_matches_the_ports_host_oracle(width):
    """Best hypothesis, the beam's full contents and scores, chunk by
    chunk, with stream 0 restarting at chunk 2."""
    _, cfg, _, params = _setup(seed=0)
    B, chunks = 2, 4
    enc = _encodings(1, cfg, B, chunks)
    host = tr.RNNTBeamDecoder(params, cfg, beam_width=width)
    hypos = [None] * B
    state = tb.init_beam_state(cfg, B, width, cap=32, device="cpu")
    for c in range(chunks):
        reset = torch.tensor([c in (0, 2), c == 0])
        state, toks, lens = tb.rnnt_beam_chunk_step(
            params, cfg, torch.from_numpy(enc[:, c]), state, reset=reset)
        for b in range(B):
            hypos[b] = host.step_chunk(
                enc[b, c], None if bool(reset[b]) else hypos[b])
            assert [int(t) for t in toks[b, :int(lens[b])]] == \
                list(hypos[b][0].tokens), (c, b)
            want = {tuple(h.tokens): h.score for h in hypos[b]}
            got = _device_valid(state, b)
            assert {t for t, _ in got} == set(want), (c, b)
            for t, sc in got:
                assert sc == pytest.approx(want[t], abs=1e-3), (c, b, t)


def test_host_oracle_matches_the_jax_host_oracle():
    jcfg, tcfg, jparams, tparams = _setup(seed=2)
    enc = _encodings(3, jcfg, 1, 3)[0]
    jh = th = None
    jhost = jr.RNNTBeamDecoder(jparams, jcfg, beam_width=3)
    thost = tr.RNNTBeamDecoder(tparams, tcfg, beam_width=3)
    for c in range(3):
        jh, th = jhost.step_chunk(enc[c], jh), thost.step_chunk(enc[c], th)
        assert [h.tokens for h in th] == [h.tokens for h in jh]
        np.testing.assert_allclose([h.score for h in th],
                                   [h.score for h in jh], rtol=1e-4, atol=1e-4)


def test_token_capacity_clamps():
    """Overflowing the CAP token buffer drops tokens and corrupts none."""
    _, cfg, _, params = _setup(seed=6)
    state = tb.init_beam_state(cfg, 1, 2, cap=4, device="cpu")
    enc = torch.from_numpy(_encodings(7, cfg, 1, 8, scale=3.0))
    for c in range(8):
        state, toks, lens = tb.rnnt_beam_chunk_step(
            params, cfg, enc[:, c], state,
            reset=torch.tensor([c == 0]))
    assert int(lens[0]) <= 4
    assert int(toks.min()) >= 0 and int(toks.max()) < cfg.vocab_size


def test_rescorer_decodes_a_segment():
    """make_rnnt_rescorer: the host beam over a segment's encodings equals
    the best hypothesis of step_chunk, detokenized."""
    _, cfg, _, params = _setup(seed=8, vocab=6)
    pieces = ["▁a", "▁b", "c", "d", "e", "<b>"]
    enc = _encodings(9, cfg, 1, 1, scale=2.0)[0, 0]

    class Segment:
        emission, length = np.concatenate([enc, enc]), 4
    text = tr.make_rnnt_rescorer(params, cfg, pieces, beam_width=3)(Segment)
    best = tr.RNNTBeamDecoder(params, cfg, 3).step_chunk(enc)[0]
    assert text == tr.detokenize_pieces(best.tokens, pieces)
    Segment.length = 0
    assert tr.make_rnnt_rescorer(params, cfg, pieces)(Segment) == ""
