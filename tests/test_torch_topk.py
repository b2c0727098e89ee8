"""The port's iter_topk twin (the plain version of the row top-k CUDA
kernel) vs jax.lax.top_k, vs pallas_row_topk in interpret mode and vs the
stable descending sort.

Everything is exact (values and indices): the selection is comparisons and
integer logic on unchanged values, ties to the lowest index.  Inputs come
from a numpy seed.  ``row_topk`` on a CPU tensor is ``iter_topk``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.ops.pallas_topk import pallas_row_topk
from asr_streaming_tpu_torch.ops import row_topk as rk
from asr_streaming_tpu_torch.ops.topk import (
    iter_topk, iter_topk_values, row_topk,
)


def _check(x: np.ndarray, k: int, pallas: bool = True):
    """torch twin == lax.top_k == stable sort (== the Pallas kernel where
    its domain, finite f32, holds)."""
    tv, ti = row_topk(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32 and tv.dtype == torch.float32
    ev, ei = jax.lax.top_k(jnp.asarray(x), k)
    np.testing.assert_array_equal(np.asarray(ev), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ei), ti.numpy())
    sv, si = torch.sort(torch.from_numpy(x), dim=-1, descending=True,
                        stable=True)
    assert torch.equal(tv, sv[..., :k]) and torch.equal(ti.long(), si[..., :k])
    if pallas:
        pv, pi = pallas_row_topk(jnp.asarray(x), k, interpret=True)
        np.testing.assert_array_equal(np.asarray(pv), tv.numpy())
        np.testing.assert_array_equal(np.asarray(pi), ti.numpy())


@pytest.mark.parametrize("shape,k", [
    ((7, 130), 5),          # just past one block
    ((3, 128), 10),         # exactly one block
    ((4, 4097), 10),        # the beam's per-hypothesis vocab row
    ((2, 5, 517), 10),      # leading batch dims
    ((3, 100), 10),         # the beam's flat [B, W * kcap] table
    ((3, 50), 10),          # the end-of-frame table
    ((2, 1000), 128),       # the widest k
])
def test_matches_lax_topk_pallas_and_stable_sort(shape, k):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    _check(x, k)


def test_ties_resolve_to_lowest_index():
    x = np.zeros((3, 300), np.float32)
    x[0, [5, 133, 299]] = 7.0        # ties spanning three blocks
    x[1, [40, 41, 42]] = 2.5         # ties inside one block
    x[2, :] = 1.0                    # fully degenerate row
    _check(x, 6)


def test_sentinel_heavy_rows():
    # beam-like rows: mostly -1e30 sentinels, few live entries
    x = np.full((4, 4097), -1.0e30, np.float32)
    x[0, 17] = -3.2
    x[1, [100, 200]] = [-1.0, -1.0]
    _check(x, 10)


def test_neg_inf_and_below_sentinel_rows():
    # selection is positional: -inf rows and values below -3e38 never let
    # padding win (indices stay in range); outside the Pallas kernel's
    # finite domain, so held against lax.top_k and the sort only
    x = np.full((5, 300), -np.inf, np.float32)
    x[0, [2, 250]] = [-3.1e38, -3.3e38]
    x[1, 7] = -1.0                        # one live entry, rest -inf
    x[3, 299] = 0.5                       # live entry in the padded block
    x[4, [0, 128, 256]] = -3.2e38
    _check(x, 6, pallas=False)
    i = iter_topk(torch.from_numpy(x), 6)[1]
    assert int(i.max()) < 300 and int(i.min()) >= 0


def test_all_equal_rows_give_ascending_indices():
    x = np.full((2, 130), -np.inf, np.float32)
    _check(x, 5, pallas=False)
    assert iter_topk(torch.from_numpy(x), 5)[1].tolist() == [[0, 1, 2, 3, 4]] * 2


def test_bfloat16_values_keep_their_dtype():
    x32 = np.random.default_rng(1).standard_normal((3, 515)).astype(np.float32)
    xj = jnp.asarray(x32).astype(jnp.bfloat16)
    xt = torch.from_numpy(x32).to(torch.bfloat16)
    ev, ei = jax.lax.top_k(xj, 4)
    tv, ti = iter_topk(xt, 4)
    assert tv.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(ev, np.float32),
                                  tv.float().numpy())
    np.testing.assert_array_equal(np.asarray(ei), ti.numpy())


def test_one_dimensional_input_and_values_only():
    x = np.random.default_rng(2).standard_normal(600).astype(np.float32)
    ev, ei = jax.lax.top_k(jnp.asarray(x), 8)
    tv, ti = iter_topk(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(np.asarray(ev), tv.numpy())
    np.testing.assert_array_equal(np.asarray(ei), ti.numpy())
    assert torch.equal(iter_topk_values(torch.from_numpy(x), 8), tv)


def test_large_k_on_rows_with_neg_inf_raises():
    """The JAX function silently returns wrong indices there (an emptied
    block's cached max ties the real -inf entries); the port refuses."""
    x = torch.zeros((2, 400))
    assert iter_topk(x, 200)[1][0].tolist() == list(range(200))
    x[0, 5] = float("-inf")
    assert iter_topk(x, 128)[1].shape == (2, 128)        # k <= 128 is fine
    with pytest.raises(ValueError, match="-inf"):
        iter_topk(x, 200)
    with pytest.raises(ValueError, match="N=400 < k=401"):
        iter_topk(x, 401)


def test_kernel_wrapper_takes_cuda_tensors_only():
    """On the CPU the dispatcher takes the plain version; the kernel's own
    wrapper never falls back."""
    x = torch.zeros((2, 64))
    n0 = rk.LAUNCHES
    with pytest.raises(ValueError, match="not on a CUDA device"):
        rk.cuda_row_topk(x, 4)
    row_topk(x, 4)
    assert rk.LAUNCHES == n0


@pytest.mark.parametrize("k,n_max", [(1, rk.MAX_N), (10, rk.MAX_N),
                                     (16, rk.MAX_N), (17, rk.MAX_N_LARGE_K),
                                     (128, rk.MAX_N_LARGE_K)])
def test_kernel_limits_by_k(k, n_max):
    """The kernel's row limit depends on k: the wide kernel (k <= 16)
    streams rows up to 2^24 values, the block kernel (k > 16) stages up to
    46,000 in shared memory; rows up to 256 take any k <= N.  The limits
    are checked before the device."""
    assert rk.max_n(k) == n_max
    rk.check_args((3, n_max), k)
    rk.check_args((3, 256), min(k, 256))
    with pytest.raises(ValueError, match=f"N={n_max + 1} > {n_max}"):
        rk.check_args((3, n_max + 1), k)


@pytest.mark.parametrize("shape,k,match", [
    ((3, 300), 0, "k=0 not in"), ((3, 300), 129, "k=129 not in"),
    ((3, 20), 21, "N=20 < k=21"), ((), 1, "shape")])
def test_kernel_rejects_what_it_does_not_take(shape, k, match):
    with pytest.raises(ValueError, match=match):
        rk.check_args(shape, k)
