"""The port's W8A8 mode (kernel A's int8 mode, kernel C's int8) vs the JAX
package's.

The helpers must agree exactly: ``_quantize_weight`` gives the same int8
values and scales, ``_qdot`` the same f32 outputs.  Through the layers an
int8 value flips wherever the two frameworks' f32 LN rows differ in the
last bit and sit on a rounding boundary, and one flip moves a slot's
whole output by up to ~2e-2 (measured on these inputs), so the routes
are held to the bf16 tolerance, 3e-2, with the JAX package's own
statistical bound (tests/test_pallas_emformer.py:154-165) against the
unquantised oracle beside it.  The contract of where ``quant`` applies
is exact: "int8_ffn" on the layer route and any quant on the eager route
change nothing.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.ops import pallas_emformer as jpe
from asr_streaming_tpu_torch.models import emformer as te
from asr_streaming_tpu_torch.ops import emformer_stack as es
from tests.test_torch_emformer import (
    EN, VI, _inputs, _run_jax, _run_torch, _setup,
)

QTOL = 3e-2


@pytest.mark.parametrize("shape", [(64, 96), (3, 96, 64), (2, 512, 40)])
def test_quantize_weight_equals_jax(shape):
    w = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    w[..., 3] = 0.0                    # an all-zero channel: the 1e-8 floor
    jw8, js = jpe._quantize_weight(jnp.asarray(w), axis=-2)
    tw8, ts = es._quantize_weight(torch.from_numpy(w), axis=-2)
    assert tw8.dtype == torch.int8
    np.testing.assert_array_equal(tw8.numpy(), np.asarray(jw8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("K", [64, 512, 2048])
def test_qdot_equals_jax(K):
    rng = np.random.default_rng(K)
    x = (rng.standard_normal((37, K)) * 3).astype(np.float32)
    x[5] = 0.0                         # an all-zero row
    w = rng.standard_normal((K, 48)).astype(np.float32)
    jw8, js = jpe._quantize_weight(jnp.asarray(w), axis=-2)
    want = np.asarray(jpe._qdot(jnp.asarray(x), jw8, js))
    tw8, ts = es._quantize_weight(torch.from_numpy(w), axis=-2)
    got = es._qdot(torch.from_numpy(x), tw8, ts)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("K", [64, 208, 2048])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_row_quantiser_equals_jax_qdot(dtype, K):
    """_qdot(x, I_K, ones) returns xq * s in f32: the port's row quantiser
    (``quantize_rows_plain``, what the kernels' quantisation is held to)
    gives the same xq and s, bit for bit, for f32 rows and for bf16 rows
    read as f32 (as _qdot(x.astype(f32)) reads them), with an all-zero
    row and rows that hold +-amax."""
    rng = np.random.default_rng(K + len(dtype))
    x = (rng.standard_normal((23, K)) * 3).astype(np.float32)
    x[2] = 0.0                          # the 1e-8 floor
    x[5, 7], x[5, 11] = 9.5, -9.5       # both signs of the amax
    x[6, 3] = -2 * np.abs(x[6]).max()   # a negative amax
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        xt = xt.to(torch.bfloat16)
    xq, s = es.quantize_rows(xt)
    assert xq.dtype == torch.int8 and s.dtype == torch.float32
    assert xq.shape == (23, K) and s.shape == (23,)
    want = np.asarray(jpe._qdot(jnp.asarray(xt.float().numpy()),
                                jnp.eye(K, dtype=jnp.int8),
                                jnp.ones((1, K), jnp.float32)))
    np.testing.assert_array_equal((xq.float() * s[:, None]).numpy(), want)
    assert not xq[2].any()


def test_quant_names_match_jax():
    jname = {"wq": "w_q", "wkv": "w_kv", "wout": "w_out", "ffw1": "ff_w1",
             "ffw2": "ff_w2"}
    for quant in (False, True, "none", "int8", "int8_ffn"):
        want = tuple(jname[n] for n in jpe._kernel_quant_names(quant))
        assert es._kernel_quant_names(quant) == want


def test_quantized_weights_are_cached_per_tensor():
    p = {"w_q": torch.randn(2, 16, 8)}
    a = es.quantized_weights(p, ["w_q"])["w_q"]
    assert es.quantized_weights(p, ["w_q"])["w_q"][0] is a[0]
    with torch.no_grad():
        p["w_q"].mul_(2.0)             # in place: quantised again
    b = es.quantized_weights(p, ["w_q"])["w_q"]
    assert b[0] is not a[0]
    torch.testing.assert_close(b[1], 2 * a[1])


def test_kernel_copies_share_the_weight_cache():
    """The kernel's cast / transposed weight copies and the int8 weights
    live in one per-tensor cache: each copy is made once, kept apart by
    its tag, made again after an in-place change, and dropped with the
    tensor."""
    w = torch.randn(2, 16, 8)
    t = es._kernel_tensor(w, torch.bfloat16, transpose=True)
    assert t.shape == (2, 8, 16) and t.dtype == torch.bfloat16
    assert es._kernel_tensor(w, torch.bfloat16, transpose=True) is t
    assert es._kernel_tensor(w, torch.bfloat16) is not t
    assert es._kernel_tensor(w, torch.float32) is w      # no copy needed
    q = es.quantized_weights({"w": w}, ["w"])["w"]
    assert es.quantized_weights({"w": w}, ["w"])["w"] is q
    with torch.no_grad():
        w.add_(1.0)
    t2 = es._kernel_tensor(w, torch.bfloat16, transpose=True)
    assert t2 is not t
    torch.testing.assert_close(t2, w.to(torch.bfloat16).transpose(1, 2))
    keys = [k for k in es._CACHE if k[0] == id(w)]
    assert len(keys) == 3
    del w, t2
    import gc
    gc.collect()
    assert not any(k in es._CACHE for k in keys)


def _quant_runs(geo, quant, jax_mode, route, seed):
    jcfg, tcfg, jparams, tparams, _ = _setup(geo, "f32", seed=seed)
    xs, rs, adv = _inputs(geo, 3, 4, seed=seed + 1)
    fused = (dict(use_pallas_stack=True, pallas_stack_tile=2)
             if jax_mode == "stack"
             else dict(use_pallas_layer=True, pallas_tile=2))
    want = _run_jax(dataclasses.replace(jcfg, quant=quant, **fused), jparams,
                    xs, rs, adv)
    got = _run_torch(te.emformer_stream_step,
                     dataclasses.replace(tcfg, route=route, quant=quant),
                     tparams, xs, rs, adv)
    oracle = _run_torch(te.emformer_stream_step, tcfg, tparams, xs, rs, adv)
    return np.stack(got[0]), np.stack(want[0]), np.stack(oracle[0]), got, want


@pytest.mark.parametrize("route,quant", [("stack", "int8"),
                                         ("stack", "int8_ffn"),
                                         ("layer", "int8")])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_quantised_routes_match_jax(geo, route, quant):
    ys, yj, yo, got, want = _quant_runs(geo, quant, route, route, seed=21)
    np.testing.assert_allclose(ys, yj, rtol=QTOL, atol=QTOL)
    for sg, sw in zip(got[1], want[1]):
        np.testing.assert_array_equal(sg.length, sw.length)
        for name in ("mem", "lc_k", "lc_v"):
            np.testing.assert_allclose(getattr(sg, name), getattr(sw, name),
                                       rtol=QTOL, atol=QTOL, err_msg=name)
    # and the JAX package's own bound against the unquantised oracle
    assert np.abs(ys - yo).max() / np.abs(yo).max() < 0.08
    assert np.corrcoef(ys.ravel(), yo.ravel())[0, 1] > 0.995


@pytest.mark.parametrize("route,quant", [("layer", "int8_ffn"),
                                         ("eager", "int8"),
                                         ("eager", "int8_ffn")])
def test_quant_ignored_where_jax_ignores_it(route, quant):
    _, tcfg, _, tparams, _ = _setup(VI, "bf16", seed=23)
    xs, rs, adv = _inputs(VI, 3, 4, seed=24)
    base = dataclasses.replace(tcfg, route=route)
    plain = _run_torch(te.emformer_stream_step, base, tparams, xs, rs, adv)
    quantised = _run_torch(te.emformer_stream_step,
                           dataclasses.replace(base, quant=quant), tparams,
                           xs, rs, adv)
    for a, b in zip(plain[0], quantised[0]):
        np.testing.assert_array_equal(a, b)


def test_int8_layer_route_equals_int8_stack_route():
    """Both routes run the same layer code in int8 too (the JAX package's
    test_int8_layer_matches_int8_stack_bitexact)."""
    _, tcfg, _, tparams, _ = _setup(VI, "f32", seed=25)
    xs, rs, adv = _inputs(VI, 3, 4, seed=26)
    cfg = dataclasses.replace(tcfg, quant="int8")
    stack = _run_torch(te.emformer_stream_step, cfg, tparams, xs, rs, adv)
    layer = _run_torch(te.emformer_stream_step,
                       dataclasses.replace(cfg, route="layer"), tparams, xs,
                       rs, adv)
    for a, b in zip(stack[0], layer[0]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("config", [-1, 4, 7])
def test_w8a8_linear_config_out_of_range_raises(config):
    """The tile index is checked before the device: out of range raises
    on the CPU too (as gemm_bf16's does)."""
    w = torch.randn(64, 32)
    q = es.quantized_weights({"w": w}, ["w"])["w"]
    last = len(es.GEMM_TILES) - 1
    with pytest.raises(ValueError, match=f"config {config} not in 0..{last}"):
        es.w8a8_linear(torch.randn(5, 64), q, torch.zeros(32),
                       torch.bfloat16, config=config)
    with pytest.raises(ValueError, match=f"config {config} not in 0..{last}"):
        es.gemm_bf16(torch.randn(5, 64), w, torch.zeros(32), config=config)


@pytest.mark.parametrize("config", [None, 0, len(es.GEMM_TILES) - 1])
@pytest.mark.parametrize("activation", [None, "gelu"])
def test_w8a8_linear_on_the_cpu_is_the_plain_version(config, activation):
    """A forced tile changes nothing on a CPU tensor: the plain version,
    _qdot then the bias and the activation in the compute type, exactly;
    the card's tile entry is never reached."""
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((7, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((64, 48)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(48).astype(np.float32))
    q = es.quantized_weights({"w": w}, ["w"])["w"]
    got = es.w8a8_linear(x, q, b, torch.bfloat16, activation, config)
    want = es._qdot(x, q[0], q[1]).to(torch.bfloat16) + b.to(torch.bfloat16)
    if activation:
        want = torch.nn.functional.gelu(want, approximate="tanh")
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
