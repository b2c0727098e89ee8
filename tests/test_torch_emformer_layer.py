"""The port's layer route (kernel C) vs the JAX package's.

The port's ``emformer_layer`` (its kernel's plain version on the CPU) is
held against JAX's ``fused_emformer_layer`` in interpret mode, one call
and the whole route (``use_pallas_layer``) with per-slot reset/advance
churn; the port's layer route against its stack route bit for bit (the
two run the same layer code); and ``with_kernel_route`` against the
environment variables operators set.  Geometries are those of
tests/test_pallas_emformer.py; tolerances the JAX package's own for its
kernel: 2e-5 in f32, 3e-2 in bf16; lengths exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import emformer as je
from asr_streaming_tpu.ops.pallas_emformer import fused_emformer_layer
from asr_streaming_tpu_torch.models import asr as ta
from asr_streaming_tpu_torch.models import emformer as te
from asr_streaming_tpu_torch.ops.emformer_layer import emformer_layer
from tests.test_torch_emformer import (
    DTYPES, EN, VI, _compare, _inputs, _run_jax, _run_torch, _setup,
)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_layer_route_matches_jax_layer_route(geo, dtype):
    jcfg, tcfg, jparams, tparams, tol = _setup(geo, dtype, seed=11)
    xs, rs, adv = _inputs(geo, 3, 4, seed=12)
    want = _run_jax(dataclasses.replace(jcfg, use_pallas_layer=True,
                                        pallas_tile=2), jparams, xs, rs, adv)
    got = _run_torch(te.emformer_stream_step,
                     dataclasses.replace(tcfg, route="layer"), tparams, xs,
                     rs, adv)
    _compare(got, want, tol)


@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_layer_route_equals_stack_route(geo):
    _, tcfg, _, tparams, _ = _setup(geo, "bf16", seed=13)
    xs, rs, adv = _inputs(geo, 3, 4, seed=14)
    stack = _run_torch(te.emformer_stream_step, tcfg, tparams, xs, rs, adv)
    layer = _run_torch(te.emformer_stream_step,
                       dataclasses.replace(tcfg, route="layer"), tparams, xs,
                       rs, adv)
    for ys, yl in zip(stack[0], layer[0]):
        np.testing.assert_array_equal(yl, ys)
    for ss, sl in zip(stack[1], layer[1]):
        for a, b in zip(sl, ss):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_one_layer_call_matches_fused_emformer_layer(geo, dtype):
    """One call, the JAX signature: six outputs, M=0 dummies included."""
    jdt, tdt, tol = DTYPES[dtype]
    cfg = je.EmformerConfig(**geo, compute_dtype=jdt)
    jp = jax.tree.map(lambda a: a[1],
                      je.init_emformer_params(jax.random.PRNGKey(15), cfg))
    rng = np.random.default_rng(16)
    B, D = 4, cfg.d_model
    U, R = cfg.segment_length, cfg.right_context_length
    M, Lc = cfg.max_memory_size, cfg.left_context_length
    f32 = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    utt, rc, mem_row = f32(B, U, D), f32(B, R, D), f32(B, 1, D)
    mem, lck, lcv = f32(B, M, D), f32(B, Lc, D), f32(B, Lc, D)
    length = rng.integers(0, 70, B).astype(np.int32)
    reset, advance = rng.random(B) < 0.3, rng.random(B) < 0.7
    kw = dict(U=U, R=R, M=M, Lc=Lc, H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=True, neg_inf=-1e8, activation="gelu")
    want = fused_emformer_layer(
        jp, jnp.asarray(utt), jnp.asarray(rc),
        jnp.asarray(mem_row) if cfg.use_mem else None,
        jnp.asarray(mem, jdt), jnp.asarray(lck, jdt), jnp.asarray(lcv, jdt),
        jnp.asarray(length), jnp.asarray(reset), jnp.asarray(advance),
        cdt_name=jnp.dtype(jdt).name, tile=2, interpret=True, **kw)
    t = torch.from_numpy
    tp = {k: t(np.array(v)) for k, v in jp.items()}
    got = emformer_layer(
        tp, t(utt), t(rc), t(mem_row) if cfg.use_mem else None,
        t(mem).to(tdt), t(lck).to(tdt), t(lcv).to(tdt), t(length),
        t(reset), t(advance), cdt=tdt, **kw)
    for name, g, w in zip(("utt", "rc", "mem_row", "mem", "lc_k", "lc_v"),
                          got, want):
        if w is None:
            assert g is None, name
            continue
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=tol,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("env,args,want", [
    ({}, {}, ("stack", "none")),
    ({}, {"mode": "layer", "quant": "int8"}, ("layer", "int8")),
    ({"ASR_PALLAS_MODE": "layer"}, {}, ("layer", "none")),
    ({"ASR_PALLAS_MODE": "off", "ASR_PALLAS_QUANT": "int8"}, {},
     ("eager", "none")),
    ({"ASR_PALLAS_QUANT": "int8_ffn"}, {"mode": "layer"},
     ("layer", "int8_ffn")),
])
def test_with_kernel_route_reads_the_operators_variables(monkeypatch, env,
                                                         args, want):
    for k in ("ASR_PALLAS_MODE", "ASR_PALLAS_QUANT"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = ta.with_kernel_route(ta.ASRConfig.tiny(), **args)
    emf = cfg.encoder.emformer
    assert (emf.route, emf.quant) == want
    monkeypatch.setenv("ASR_PALLAS_MODE", "tpu")
    with pytest.raises(ValueError):
        ta.with_kernel_route(ta.ASRConfig.tiny())
    with pytest.raises(ValueError):
        te.EmformerConfig(quant="fp8")
