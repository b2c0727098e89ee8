"""The port's fused attention core (kernel D) vs the JAX package's.

``emformer_attention`` (its kernel's plain version on the CPU) against
``fused_emformer_attention`` in interpret mode at 1e-5 (f32 throughout,
only the summation order differs), and the eager route with
``fused_attention`` against JAX's XLA route with ``use_pallas_attention``
at the JAX package's tolerances, with reset/advance churn.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asr_streaming_tpu.ops.pallas_attention import fused_emformer_attention
from asr_streaming_tpu_torch.models import emformer as te
from asr_streaming_tpu_torch.ops.emformer_attention import emformer_attention
from tests.test_torch_emformer import (
    EN, VI, _compare, _inputs, _run_jax, _run_torch, _setup,
)


@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_attention_core_matches_jax_kernel(geo):
    rng = np.random.default_rng(31)
    B, D, H = 5, geo["d_model"], geo["num_heads"]
    U, R = geo["segment_length"], geo["right_context_length"]
    M, Lc = geo["max_memory_size"], geo["left_context_length"]
    use_mem = M > 0
    Q, K = R + U + (1 if use_mem else 0), M + R + Lc + U
    q = rng.standard_normal((B, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, K, D)).astype(np.float32)
    v = rng.standard_normal((B, K, D)).astype(np.float32)
    length = np.array([0, 3, U, 5 * U + 1, 100], np.int32)
    m_kv = np.minimum(Lc, length).astype(np.int32)
    m_m = (np.minimum(M, length // U) if use_mem
           else np.zeros(B)).astype(np.int32)
    kw = dict(num_heads=H, M=M, R=R, Lc=Lc, U=U, use_mem=use_mem,
              neg_inf=-1e8)
    want = fused_emformer_attention(*map(jnp.asarray, (q, k, v, m_m, m_kv)),
                                    interpret=True, **kw)
    got = emformer_attention(*map(torch.from_numpy, (q, k, v, m_m, m_kv)),
                             **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, Q, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_eager_fused_attention_matches_jax_pallas_attention(geo, dtype):
    jcfg, tcfg, jparams, tparams, tol = _setup(geo, dtype, seed=33)
    xs, rs, adv = _inputs(geo, 3, 3, seed=34)
    want = _run_jax(dataclasses.replace(jcfg, use_pallas_attention=True),
                    jparams, xs, rs, adv)
    got = _run_torch(te.emformer_stream_step,
                     dataclasses.replace(tcfg, route="eager",
                                         fused_attention=True),
                     tparams, xs, rs, adv)
    _compare(got, want, tol)
