"""The port's training losses, sequence ops and optimizers against the
JAX package (and optax) on the same numpy inputs.

Tolerances: CTC values and gradients rtol = atol = 1e-5 against
``optax.ctc_loss``; RNN-T values 1e-5 and gradients 1e-4 relative L2
against the JAX loss and the float64 brute force of
tests/test_losses.py; every other loss and ``ops/sequence.py`` function
1e-5; the optimizers' updates, given the same gradients, 1e-6
relative L2 per leaf.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import optax

from asr_streaming_tpu.ops import sequence as jseq
from asr_streaming_tpu.train import losses as jl
from asr_streaming_tpu.train.ctc import (
    make_optimizer as j_make_optimizer, noam_annealing as j_noam,
)
from asr_streaming_tpu.models.asr import ASRConfig as JASRConfig
from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.ops import sequence as tseq
from asr_streaming_tpu_torch.train import losses as tl
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train.ctc import (
    make_optimizer as t_make_optimizer, noam_annealing as t_noam,
)
from tests.test_losses import _np_rnnt_logp_frame_tied
from tests.torch_train_common import pairs, rel_l2, to_torch

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- CTC

def _ctc_case(name):
    """(logits, logit_paddings, labels, label_paddings, feasible rows)."""
    rng = np.random.default_rng(0)
    B, T, K, N = 3, 12, 6, 4
    logits = rng.standard_normal((B, T, K)).astype(np.float32) * 2
    lpad = np.zeros((B, N), np.float32)
    tpad = np.zeros((B, T), np.float32)
    if name == "repeats":
        labels = np.array([[1, 1, 2, 2], [3, 3, 3, 1], [2, 4, 4, 5]])
    elif name == "zero_length":
        labels = np.array([[1, 2, 0, 0], [0, 0, 0, 0], [5, 0, 0, 0]])
        lpad[0, 2:] = 1
        lpad[1, :] = 1
        lpad[2, 1:] = 1
    elif name == "paddings":
        labels = np.array([[1, 2, 3, 0], [4, 4, 0, 0], [2, 5, 1, 3]])
        lpad[0, 3:] = 1
        lpad[1, 2:] = 1
        tpad[0, 9:] = 1
        tpad[1, 5:] = 1
    else:                         # "impossible": 4 labels in 2 frames
        labels = np.array([[1, 2, 0, 0], [3, 4, 5, 2], [2, 2, 0, 0]])
        lpad[0, 2:] = 1
        lpad[2, 2:] = 1
        tpad[1, 2:] = 1
        tpad[2, 2:] = 1           # a repeat needs a blank between: 3 frames
    feasible = [0] if name == "impossible" else [0, 1, 2]
    return logits, tpad, labels.astype(np.int32), lpad, feasible


@pytest.mark.parametrize("name", ["repeats", "zero_length", "paddings",
                                  "impossible"])
def test_ctc_loss_matches_optax(name):
    logits, tpad, labels, lpad, feasible = _ctc_case(name)
    B = logits.shape[0]
    weights = np.arange(1, B + 1, dtype=np.float32)

    def jf(lg):
        per = optax.ctc_loss(lg, jnp.asarray(tpad), jnp.asarray(labels),
                             jnp.asarray(lpad), blank_id=0)
        return jnp.sum(per * weights), per

    (_, jper), jgrad = jax.value_and_grad(jf, has_aux=True)(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    per = tl.ctc_loss(x, _t(tpad), _t(labels), _t(lpad), blank_id=0)
    (per * _t(weights)).sum().backward()
    np.testing.assert_allclose(per.detach().numpy(), np.asarray(jper), **TOL)
    assert np.isfinite(per.detach().numpy()).all()
    assert np.isfinite(x.grad.numpy()).all()
    # an impossible row costs about -T * log_epsilon: its path weights sit
    # near 1e5, where an f32 ulp is 7.8e-3, so both gradients carry that
    # rounding; the feasible rows' gradients are compared
    np.testing.assert_allclose(x.grad.numpy()[feasible],
                               np.asarray(jgrad)[feasible], **TOL)
    if name == "impossible":
        assert per[1] > 1e4 and per[2] > 1e4


@pytest.mark.parametrize("name", ["repeats", "zero_length", "paddings"])
def test_ctc_loss_matches_torch_ctc_on_feasible_cases(name):
    """F.ctc_loss (lengths, [T, B, C], inf when impossible) as a second
    oracle where every alignment exists."""
    logits, tpad, labels, lpad, _ = _ctc_case(name)
    got = tl.ctc_loss(_t(logits), _t(tpad), _t(labels), _t(lpad))
    lp = torch.log_softmax(_t(logits), -1).transpose(0, 1)
    want = F.ctc_loss(lp, _t(labels).long(),
                      _t((1 - tpad).sum(1)).long(),
                      _t((1 - lpad).sum(1)).long(), blank=0,
                      reduction="none")
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


# ---------------------------------------------------------------- RNN-T

@pytest.mark.parametrize("B,T,U,V,lens", [
    (2, 5, 3, 7, None),
    (3, 6, 4, 5, ([6, 4, 5], [4, 2, 3])),
    (2, 9, 6, 11, ([9, 7], [6, 0])),
])
def test_rnnt_loss_matches_jax_and_bruteforce(B, T, U, V, lens):
    rng = np.random.default_rng(U)
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    targets = rng.integers(1, V, size=(B, U)).astype(np.int32)
    t_lens, u_lens = (np.asarray(x, np.int32) for x in (
        lens or ([T] * B, [U] * B)))
    jv, jg = jax.value_and_grad(lambda lg: jl.rnnt_loss(
        lg, jnp.asarray(t_lens), jnp.asarray(targets),
        jnp.asarray(u_lens)))(jnp.asarray(logits))
    x = _t(logits).requires_grad_(True)
    tv = tl.rnnt_loss(x, _t(t_lens), _t(targets), _t(u_lens))
    tv.backward()
    tv = float(tv.detach())
    np.testing.assert_allclose(tv, float(jv), **TOL)
    assert rel_l2(x.grad.numpy(), jg) <= 1e-4
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), axis=-1),
                      np.float64)
    brute = -np.mean([_np_rnnt_logp_frame_tied(
        logp[b, :t_lens[b]], targets[b, :u_lens[b]]) for b in range(B)])
    np.testing.assert_allclose(tv, brute, **TOL)


def test_rnnt_loss_gradient_is_nearer_float64_than_the_jax_scan():
    """At a longer lattice (U = 40) the f32 gradients part from the JAX
    scan's by more than 1e-4; against the same closure in float64 the
    port's is the nearer of the two."""
    rng = np.random.default_rng(0)
    B, T, U, V = 2, 60, 40, 300
    logits = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    targets = rng.integers(1, V, (B, U)).astype(np.int32)
    t_lens, u_lens = np.array([T, T - 7], np.int32), np.array([U, U - 5],
                                                              np.int32)
    jg = np.asarray(jax.jit(jax.grad(lambda lg: jl.rnnt_loss(
        lg, jnp.asarray(t_lens), jnp.asarray(targets),
        jnp.asarray(u_lens))))(jnp.asarray(logits)))
    grads = {}
    for dt in (torch.float32, torch.float64):
        x = _t(logits).to(dt).requires_grad_(True)
        tl.rnnt_loss(x, _t(t_lens), _t(targets), _t(u_lens)).backward()
        grads[dt] = x.grad.numpy()
    ref = grads[torch.float64]
    ours, theirs = rel_l2(grads[torch.float32], ref), rel_l2(jg, ref)
    assert ours <= 1e-4 and ours < theirs, (ours, theirs)


def test_sequence_to_sequence_loss_matches_jax():
    rng = np.random.default_rng(3)
    B, T, U, V = 2, 6, 3, 7
    ctc = jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((B, T, V)), jnp.float32))
    rnnt = rng.standard_normal((B, T, U + 1, V)).astype(np.float32)
    targets = rng.integers(1, V, size=(B, U)).astype(np.int32)
    lens, ulens = np.array([6, 5], np.int32), np.array([3, 2], np.int32)
    want = jl.sequence_to_sequence_loss(ctc, jnp.asarray(rnnt),
                                        jnp.asarray(lens),
                                        jnp.asarray(targets),
                                        jnp.asarray(ulens), 0.3, 0.7)
    got = tl.sequence_to_sequence_loss(_t(np.asarray(ctc)), _t(rnnt),
                                       _t(lens), _t(targets), _t(ulens),
                                       0.3, 0.7)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), **TOL)


# ---------------------------------------------------------------- the rest

def _other_losses(name, rng):
    """(JAX value, port value) of one loss on the same inputs."""
    if name == "am_softmax":
        W = rng.standard_normal((8, 5)).astype(np.float32)
        x = rng.standard_normal((6, 8)).astype(np.float32)
        y = rng.integers(0, 5, 6).astype(np.int32)
        jloss, jpred = jl.additive_margin_softmax_loss(
            {"W": jnp.asarray(W)}, jnp.asarray(x), jnp.asarray(y))
        tloss, tpred = tl.additive_margin_softmax_loss(
            {"W": _t(W)}, _t(x), _t(y))
        np.testing.assert_array_equal(tpred.numpy(), np.asarray(jpred))
        return jloss, tloss
    if name == "random_quantization":
        jp = jl.init_random_quantizer(jax.random.PRNGKey(1), 16, 12, 8, 20)
        enc = rng.standard_normal((2, 10, 12)).astype(np.float32)
        feats = rng.standard_normal((2, 10, 16)).astype(np.float32)
        pos = rng.random((2, 10)) > 0.4
        lens = np.array([10, 6], np.int32)
        return (jl.random_quantization_loss(jp, jnp.asarray(enc),
                                            jnp.asarray(lens),
                                            jnp.asarray(feats),
                                            jnp.asarray(pos)),
                tl.random_quantization_loss(to_torch(jp), _t(enc), _t(lens),
                                            _t(feats), _t(pos)))
    if name in ("ls_generative", "ls_adversarial"):
        outs = [rng.standard_normal((2, 1, n)).astype(np.float32)
                for n in (7, 13)]
        tgts = [rng.standard_normal((2, 1, n)).astype(np.float32)
                for n in (7, 13)]
        if name == "ls_generative":
            return (jl.least_squares_generative_loss(
                        [jnp.asarray(o) for o in outs]),
                    tl.least_squares_generative_loss([_t(o) for o in outs]))
        return (jl.least_squares_adversarial_loss(
                    [jnp.asarray(o) for o in outs],
                    [jnp.asarray(t) for t in tgts]),
                tl.least_squares_adversarial_loss([_t(o) for o in outs],
                                                  [_t(t) for t in tgts]))
    if name in ("stft", "multi_resolution_stft"):
        a = (rng.standard_normal((2, 3000)) * 0.3).astype(np.float32)
        b = (rng.standard_normal((2, 3000)) * 0.3).astype(np.float32)
        lens = np.array([3000, 2100], np.int32)
        if name == "stft":
            res = (256, 200, 64)
            return (jl.stft_loss(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(lens), jl.STFTResolution(*res)),
                    tl.stft_loss(_t(a), _t(b), _t(lens),
                                 tl.STFTResolution(*res)))
        res = ((512, 300, 60), (256, 120, 25))
        return (jl.multi_resolution_stft_loss(jnp.asarray(a), jnp.asarray(b),
                                              jnp.asarray(lens), res),
                tl.multi_resolution_stft_loss(_t(a), _t(b), _t(lens), res))
    outs = np.abs(rng.standard_normal((3, 9))).astype(np.float32) * 4
    tgts = rng.integers(0, 6, (3, 9)).astype(np.float32)
    outs[0, :2] = 0.0
    return (jl.temporal_prediction_loss(jnp.asarray(outs),
                                        jnp.asarray(tgts)),
            tl.temporal_prediction_loss(_t(outs), _t(tgts)))


@pytest.mark.parametrize("name", [
    "am_softmax", "random_quantization", "ls_generative", "ls_adversarial",
    "stft", "multi_resolution_stft", "temporal_prediction"])
def test_losses_match_jax(name):
    want, got = _other_losses(name, np.random.default_rng(7))
    np.testing.assert_allclose(float(got), float(want), **TOL)


# ---------------------------------------------------------------- sequence

@pytest.mark.parametrize("name", [
    "padding_mask", "statistic", "length_regulator", "word_pooling_sum",
    "word_pooling_mean", "fft_full", "fft_same", "fft_valid"])
def test_sequence_ops_match_jax(name):
    rng = np.random.default_rng(11)
    lens = np.array([5, 2, 7], np.int32)
    x = rng.standard_normal((3, 7, 4)).astype(np.float32)
    if name == "padding_mask":
        want = jseq.make_padding_mask(jnp.asarray(lens), 9)
        got = tseq.make_padding_mask(_t(lens), 9)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        return
    if name == "statistic":
        outs = zip(tseq.compute_statistic(_t(x), _t(lens)),
                    jseq.compute_statistic(jnp.asarray(x), jnp.asarray(lens)))
    elif name == "length_regulator":
        durs = rng.integers(0, 4, (3, 7)).astype(np.int32)
        mask = (np.arange(7)[None] < lens[:, None]).astype(np.float32)
        jy, jl_ = jseq.length_regulator(jnp.asarray(x), jnp.asarray(mask),
                                        jnp.asarray(durs), max_out=30)
        ty, tl_ = tseq.length_regulator(_t(x), _t(mask), _t(durs),
                                        max_out=30)
        np.testing.assert_array_equal(tl_.numpy(), np.asarray(jl_))
        outs = [(ty, jy)]
    elif name.startswith("word_pooling"):
        ids = np.array([[0, 0, 1, 2, 2, -1, -1], [0, 1, 1, 1, -1, -1, -1],
                        [0, 1, 2, 3, 3, 3, 4]], np.int32)
        red = name.rsplit("_", 1)[1]
        outs = [(tseq.word_level_pooling(_t(x), _t(ids), red),
                  jseq.word_level_pooling(jnp.asarray(x), jnp.asarray(ids),
                                          red))]
    else:
        mode = name.split("_")[1]
        sig = rng.standard_normal((2, 50)).astype(np.float32)
        ker = rng.standard_normal(9).astype(np.float32)
        outs = [(tseq.fft_convolution(_t(sig), _t(ker), mode),
                  jseq.fft_convolution(jnp.asarray(sig), jnp.asarray(ker),
                                       mode))]
    for got, want in outs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------- optimizers

def _grads(rng, scale):
    return {"a": {"w": rng.standard_normal((4, 3)).astype(np.float32) * scale,
                  "b": rng.standard_normal(3).astype(np.float32) * scale},
            "c": [rng.standard_normal((2, 2)).astype(np.float32) * scale]}


def _optimizers(name):
    cfg = ASRConfig.tiny()
    jcfg = JASRConfig.tiny()
    if name == "ctc":                 # clip(5) + adamw(noam), b2 .98, eps 1e-9
        return (j_make_optimizer(jcfg, base_lr=0.5, warmup_steps=100,
                                 weight_decay=1e-2),
                t_make_optimizer(cfg, base_lr=0.5, warmup_steps=100,
                                 weight_decay=1e-2))
    if name == "adam":
        return optax.adam(1e-3), optim.adam(1e-3)
    return (optax.adamw(1e-3, weight_decay=1e-4),
            optim.adamw(1e-3, weight_decay=1e-4))


@pytest.mark.parametrize("name", ["ctc", "adam", "adamw"])
def test_optimizer_updates_match_optax(name):
    """Three updates from the same gradients: the second is clipped (its
    global norm is far above 5), the first two share the Noam rate."""
    rng = np.random.default_rng(5)
    params = _grads(rng, 1.0)
    jopt, topt = _optimizers(name)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    tparams = to_torch(params)
    tstate = topt.init(tparams)
    for step, scale in enumerate((0.1, 30.0, 0.5)):
        g = _grads(rng, scale)
        ju, jstate = jopt.update(jax.tree.map(jnp.asarray, g), jstate,
                                 jax.tree.map(jnp.asarray, params))
        tu, tstate = topt.update(to_torch(g), tstate, tparams)
        for path, got, want in pairs(tu, ju):
            # relative L2 per leaf: XLA fuses the moment updates (FMA),
            # so an element whose update cancels can differ past 1e-6
            assert rel_l2(got, want) <= 1e-6, (step, path)
        params = jax.tree.map(lambda p, u: np.asarray(p + u), params, ju)
        tparams = optim.apply_updates(tparams, to_torch(ju))


def test_noam_schedule_matches_and_first_two_updates_share_a_rate():
    j, t = j_noam(0.5, 64, 100), t_noam(0.5, 64, 100)
    for step in (0, 1, 2, 99, 100, 101, 5000):
        np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-7)
    assert t(0) == t(1)
