"""Kernel A's f32 product (``ops/emformer_stack.py::gemm_f32``) on the CPU.

The plain version against the JAX package's product as
``pallas_emformer.py:121-126`` writes it, ``jnp.dot(x, w,
preferred_element_type=f32)``, then the bias and the activation, at
rtol = atol = 2e-5 (only the f32 sum order differs), with and without
the kernel's K-slice order; the split that ``gemm_f32_config`` picks,
which must not depend on the row count; and the shapes the wrapper
refuses.  The kernel itself runs on the card
(``tests/test_torch_kernels_gpu.py -k gemm_f32``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu_torch.ops import emformer_stack as es

TOL = dict(rtol=2e-5, atol=2e-5)
_JAX_ACTS = {"relu": jax.nn.relu, "gelu": jax.nn.gelu, "silu": jax.nn.silu}

# (rows, K, N, activation): the five products of one B=1 step at the tiny
# test geometry (d_model 64, ffn 96, U=8, R=2, M=4: 11 queries, 14 key
# rows, 10 frames), then the full-width B=1 ffn1 shape
SHAPES = {
    "tiny_q": (11, 64, 64, None), "tiny_kv": (14, 64, 128, None),
    "tiny_out": (11, 64, 64, None), "tiny_ffn1": (10, 64, 96, "gelu"),
    "tiny_ffn2": (10, 96, 64, None),
    "b1_ffn1": (21, 512, 2048, "gelu"),
    "b1_ffn1_relu": (21, 512, 2048, "relu"),
    "b1_ffn1_silu": (21, 512, 2048, "silu"),
}
# (N, K) of every offline product at full width, of the tiny ones and
# of ragged ones
NK = [(512, 512), (1024, 512), (2048, 512), (512, 2048), (64, 64),
      (128, 64), (96, 64), (64, 96), (136, 200), (132, 2048)]


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    b = rng.standard_normal(N).astype(np.float32)
    return x, w, b


def _jax_product(x, w, b, act):
    y = jnp.dot(jnp.asarray(x), jnp.asarray(w),
                preferred_element_type=jnp.float32) + jnp.asarray(b)
    return np.asarray(_JAX_ACTS[act](y) if act else y)


@pytest.mark.parametrize("split", [False, True], ids=["one_sum", "k_slices"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_gemm_f32_plain_matches_jax(name, split):
    M, K, N, act = SHAPES[name]
    x, w, b = _operands(M, K, N, seed=len(name))
    ks = es.gemm_f32_config(M, N, K) if split else 0
    if split:
        assert 0 < ks < K
    got = es.gemm_f32_plain(torch.from_numpy(x), torch.from_numpy(w),
                            torch.from_numpy(b), act, splits=ks)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), _jax_product(x, w, b, act),
                               **TOL)


@pytest.mark.parametrize("act", [None, "gelu"])
def test_gemm_f32_on_the_cpu_is_the_plain_version(act):
    """A CPU tensor takes the plain version exactly, whatever the regime."""
    x, w, b = (torch.from_numpy(t) for t in _operands(21, 512, 512, 3))
    want = es.gemm_f32_plain(x, w, b, act)
    for config in (None, 0, 64):
        assert torch.equal(es.gemm_f32(x, w, b, act, config), want)


@pytest.mark.parametrize("N,K", NK)
def test_gemm_f32_config_is_the_same_for_every_small_row_count(N, K):
    """The split depends on (N, K) only: every row count of the small
    regime (1-128 rows, so B = 1-3 slots of any product) takes the same
    one, a valid one, with no empty slice."""
    slices = {es.gemm_f32_config(M, N, K) for M in range(1, 129)}
    assert len(slices) == 1
    ks = slices.pop()
    assert ks % 32 == 0 and 0 < ks <= 128
    splits = -(-K // ks)
    assert splits <= 16
    assert (splits - 1) * ks < K


def test_gemm_f32_config_fills_the_card_at_the_offline_shapes():
    """Every product of a B=1 step at full width runs at least 132
    blocks (one an SM), the 512-slot products take the tiled kernel."""
    for rows, N, K in es._product_shapes(1, 21, 24, 20, 512, 2048):
        ks = es.gemm_f32_config(rows, N, K)
        assert ks > 0
        assert -(-N // es.F32_TILE_N) * -(-K // ks) >= 132, (rows, N, K, ks)
    for rows, N, K in es._product_shapes(512, 21, 24, 20, 512, 2048):
        assert es.gemm_f32_config(rows, N, K) == 0


@pytest.mark.parametrize("M,N,K", [(129, 64, 64), (10, 130, 64),
                                   (10, 64, 202), (10, 64, 2052)])
def test_gemm_f32_config_tiles_what_the_split_k_kernel_cannot_hold(M, N, K):
    """More than 128 rows, N or K no multiple of 4 (16-byte copies), or
    K past 16 slices of 128."""
    assert es.gemm_f32_config(M, N, K) == 0


@pytest.mark.parametrize("x_shape,w_shape,b_shape,config", [
    ((5, 64), (32, 64), (64,), None),                # w is not [K, N]
    ((5, 64), (64, 32), (31,), None),                # bias is not [N]
    ((0, 64), (64, 32), (32,), None),                # no rows
    ((5, 64), (64, 32), (32,), 24),                  # no multiple of 32
    ((5, 64), (64, 32), (32,), 256),                 # above 128
    ((5, 66), (66, 32), (32,), 32),                  # K % 4
    ((5, 64), (64, 30), (30,), 32),                  # N % 4
    ((200, 64), (64, 32), (32,), 32),                # rows
    ((5, 4096), (4096, 32), (32,), 128),             # 32 slices
    ((5, 2176), (2176, 32), (32,), 128),             # 17 slices
    ((5, 64), (64, 32), (32,), -32),                 # negative
])
def test_gemm_f32_refuses_unsupported_shapes(x_shape, w_shape, b_shape,
                                             config):
    """Checked before the device, so they raise on the CPU too."""
    with pytest.raises(ValueError, match="gemm_f32"):
        es.gemm_f32(torch.zeros(x_shape), torch.zeros(w_shape),
                    torch.zeros(b_shape), None, config)


def test_f32_error_bound_covers_another_sum_order():
    """The bound holds between two valid f32 orders of the same product
    (one sum, and the kernel's K slices), through GELU too, and it is not
    vacuous: well under the values' own size."""
    x, w, b = (torch.from_numpy(t) for t in _operands(21, 512, 2048, 5))
    ks = es.gemm_f32_config(21, 2048, 512)
    for act in (None, "gelu"):
        one = es.gemm_f32_plain(x, w, b, act)
        sliced = es.gemm_f32_plain(x, w, b, act, splits=ks)
        bound = es.gemm_f32_error_bound(x, w, one, act)
        assert bool(((one - sliced).abs() <= bound).all())
        assert float(bound.max()) < 1e-2 * float(one.abs().max())
