"""The port's fused attention core (kernel D) vs the JAX package's.

``emformer_attention`` (its kernel's plain version on the CPU) against
``fused_emformer_attention`` in interpret mode at 1e-5 (f32 throughout,
only the summation order differs), the same on bf16 inputs and outputs
(bf16 in is widened exactly, a bf16 out is the f32 result rounded once:
equal to the f32 path then cast), and the eager route with
``fused_attention`` against JAX's XLA route with ``use_pallas_attention``
at the JAX package's tolerances, with reset/advance churn, also at one
and three slots (the small-B launch plan's shapes); the geometry the CUDA
core takes, refused with a clear error outside it; and the launch plan
the CUDA core computes on the host (``attention_plan``): every (slot,
head, query row) taken by exactly one warp, shared memory within a block's
227 KB, and at the serving shapes no warp without rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asr_streaming_tpu.ops.pallas_attention import fused_emformer_attention
from asr_streaming_tpu_torch.models import emformer as te
from asr_streaming_tpu_torch.ops import emformer_attention as ea
from asr_streaming_tpu_torch.ops import emformer_stack as es
from asr_streaming_tpu_torch.ops.emformer_attention import (
    check_geometry, emformer_attention,
)
from tests.test_torch_emformer import (
    EN, VI, _compare, _inputs, _run_jax, _run_torch, _setup,
)

# (kind, B, H, D, U, R, M, Lc, itemsize): A's attention ("A": bf16 on the
# tensor cores, f32 on the FMA path) or D's ("D"), at the serving shapes
# (VI and EN at 512 slots, the offline API's one and three slots), around
# the SMs (131, 133 slots) and at the core's edges (K = 128, Q = 32, a
# 16-wide head, no memory)
PLAN_SHAPES = {
    "vi_bf16_512": ("A", 512, 8, 512, 16, 4, 4, 32, 2),
    "en_bf16_512": ("A", 512, 8, 512, 4, 1, 0, 30, 2),
    "vi_f32_b1": ("A", 1, 8, 512, 16, 4, 4, 32, 4),
    "vi_f32_b3": ("A", 3, 8, 512, 16, 4, 4, 32, 4),
    "vi_f32_512": ("A", 512, 8, 512, 16, 4, 4, 32, 4),
    "vi_bf16_131": ("A", 131, 8, 512, 16, 4, 4, 32, 2),
    "vi_bf16_133": ("A", 133, 8, 512, 16, 4, 4, 32, 2),
    "k128_bf16": ("A", 7, 8, 512, 16, 4, 4, 104, 2),
    "k128_f32": ("A", 133, 8, 512, 16, 4, 4, 104, 4),
    "q32_bf16": ("A", 2, 8, 512, 16, 15, 4, 32, 2),
    "tiny_bf16": ("A", 6, 4, 64, 8, 2, 4, 16, 2),
    "tiny_f32_nomem": ("A", 6, 4, 64, 4, 1, 0, 10, 4),
    "d_f32_512": ("D", 512, 8, 512, 16, 4, 4, 32, 4),
    "d_bf16_512": ("D", 512, 8, 512, 16, 4, 4, 32, 2),
    "d_f32_b1": ("D", 1, 8, 512, 16, 4, 4, 32, 4),
    "d_bf16_131": ("D", 131, 8, 512, 16, 4, 4, 32, 2),
}
SERVING = ("vi_bf16_512", "en_bf16_512", "vi_f32_b1", "vi_f32_b3",
           "vi_f32_512", "d_f32_512", "d_bf16_512")


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


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["out_f32", "out_bf16"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16],
                         ids=["in_f32", "in_bf16"])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_attention_core_dtypes_equal_the_f32_core_then_cast(geo, in_dtype,
                                                            out_dtype):
    rng = np.random.default_rng(32)
    B, D, H = 4, geo["d_model"], geo["num_heads"]
    U, R = geo["segment_length"], geo["right_context_length"]
    M, Lc = geo["max_memory_size"], geo["left_context_length"]
    use_mem = M > 0
    Q, K = R + U + (1 if use_mem else 0), M + R + Lc + U
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)).to(in_dtype) for s in ((B, Q, D), (B, K, D), (B, K, D)))
    length = torch.tensor([0, 3, U + 1, 100], dtype=torch.int32)
    m_kv = torch.clamp(length, max=Lc)
    m_m = torch.clamp(length // U, max=M)
    kw = dict(num_heads=H, M=M, R=R, Lc=Lc, U=U, use_mem=use_mem,
              neg_inf=-1e8)
    got = emformer_attention(q, k, v, m_m, m_kv, out_dtype=out_dtype, **kw)
    f32 = emformer_attention(q.float(), k.float(), v.float(), m_m, m_kv, **kw)
    assert got.dtype == out_dtype and tuple(got.shape) == (B, Q, D)
    assert torch.equal(got, f32.to(out_dtype))
    # and the JAX kernel on the widened inputs, then cast
    want = fused_emformer_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        jnp.asarray(m_m.numpy()), jnp.asarray(m_kv.numpy()), interpret=True,
        **kw)
    want = torch.from_numpy(np.array(want)).to(out_dtype).float()
    tol = 1e-5 if out_dtype == torch.float32 else 8e-3   # one bf16 ulp
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), rtol=tol,
                               atol=tol)


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


@pytest.mark.parametrize("Q,K,Dh,dtype,mma", [
    (21, 56, 64, torch.float32, False), (5, 35, 64, torch.bfloat16, True),
    (32, 128, 16, torch.bfloat16, True), (32, 128, 4, torch.float32, False),
    (1, 1, 128, torch.bfloat16, False)],
    ids=["vi_f32", "en_bf16_mma", "edges_mma", "edges_f32", "bf16_wide"])
def test_attention_geometry_in_range_is_taken(Q, K, Dh, dtype, mma):
    check_geometry(Q, K, Dh, dtype, mma)


@pytest.mark.parametrize("Q,K,Dh,dtype,mma", [
    (33, 56, 64, torch.float32, False), (21, 129, 64, torch.float32, False),
    (21, 56, 128, torch.float32, False), (21, 56, 48, torch.float32, False),
    (21, 56, 128, torch.bfloat16, True), (21, 56, 8, torch.bfloat16, True)],
    ids=["queries", "keys", "f32_wide", "f32_not_pow2", "mma_wide",
         "mma_narrow"])
def test_attention_geometry_out_of_range_raises(Q, K, Dh, dtype, mma):
    """The shapes the CUDA attention core refuses raise a ValueError that
    names its limits, before anything is launched (this needs no card)."""
    with pytest.raises(ValueError, match="outside the CUDA kernel's geometry"):
        check_geometry(Q, K, Dh, dtype, mma)


def test_kernel_entries_refuse_keys_past_the_core():
    """D's and A's CUDA wrappers check the geometry before they load the
    library: 200 left-context keys (K > 128) raise on any device."""
    B, D, H, M, R, U, Lc = 2, 64, 4, 4, 2, 8, 200
    Q, K = R + U + 1, M + R + Lc + U
    q, kv = torch.zeros(B, Q, D), torch.zeros(B, K, D)
    fill = torch.zeros(B, dtype=torch.int32)
    with pytest.raises(ValueError, match="K=214 keys"):
        ea._emformer_attention_cuda(
            q, kv, kv, fill, fill, num_heads=H, M=M, R=R, Lc=Lc, U=U,
            use_mem=True, neg_inf=-1e8, out_dtype=torch.float32)
    cfg = te.EmformerConfig(d_model=D, num_heads=H, ffn_dim=96, num_layers=1,
                            segment_length=U, left_context_length=Lc,
                            right_context_length=R, max_memory_size=M,
                            compute_dtype=torch.bfloat16)
    params = te.init_emformer_params(torch.Generator().manual_seed(0), cfg,
                                     torch.device("cpu"))
    w = es.kernel_weights(params, torch.bfloat16)
    state = [torch.zeros(1, B, n, D, dtype=torch.bfloat16) for n in (M, Lc, Lc)]
    with pytest.raises(ValueError, match="K=214 keys"):
        es.run_chain("asr_emformer_stack", w, {}, torch.zeros(B, U + R, D),
                     fill, fill.bool(), fill.bool(), *state,
                     torch.zeros(B, D), U=U, R=R, M=M, Lc=Lc, H=H,
                     use_mem=True, tanh_on_mem=False, neg_inf=-1e8,
                     activation="gelu", cdt=torch.bfloat16)


def _plan(kind, B, H, D, U, R, M, Lc, itemsize):
    use_mem = M > 0
    if kind == "A":
        return ea.stack_attention_plan(B, H, D, U, R, M, Lc, use_mem,
                                       itemsize)
    Q, K = R + U + int(use_mem), M + R + Lc + U
    return ea.plain_attention_plan(B, Q, K, D, H, itemsize)


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_attention_plan_covers_every_query_row_once(name):
    kind, B, H, D, U, R, M, Lc, itemsize = PLAN_SHAPES[name]
    Q = R + U + int(M > 0)
    plan = _plan(*PLAN_SHAPES[name])
    seen = np.zeros((B, H, Q), np.int32)
    warps = plan["warps"] // plan["groups"]
    empty = 0
    for _, _, b, h, rows in ea.plan_rows(plan, B, H, Q):
        seen[b, h, list(rows)] += 1
        empty += len(rows) == 0
    assert (seen == 1).all(), np.argwhere(seen != 1)[:5]
    assert plan["units"] * warps == sum(1 for _ in ea.plan_rows(plan, B, H,
                                                               Q))
    if name in SERVING:
        assert empty == 0, f"{empty} warps without query rows"


@pytest.mark.parametrize("name", list(PLAN_SHAPES))
def test_attention_plan_fits_a_block(name):
    kind, B, *_ = PLAN_SHAPES[name]
    plan = _plan(*PLAN_SHAPES[name])
    assert plan["smem"] <= ea.MAX_SMEM
    assert plan["warps"] <= ea.MAX_WARPS
    assert plan["stages"] == plan["groups"] + 1
    assert plan["warps"] == plan["groups"] * plan["hpu"] * plan["wph"]
    if plan["units"] <= ea.H100_SMS:
        assert plan["groups"] == 1      # fewer units than SMs: spread them


def test_attention_plan_spreads_the_offline_step():
    """At one slot the FMA path gives each warp one query row and a head's
    21 rows three blocks of seven warps: 24 blocks, where one block a head
    left 124 of the card's 132 SMs idle."""
    plan = _plan(*PLAN_SHAPES["vi_f32_b1"])
    assert (plan["rpw"], plan["wph"], plan["splits"]) == (1, 7, 3)
    assert plan["units"] == 24


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_attention_core_matches_jax_kernel_at_few_slots(geo, B):
    """Kernel D's function at one and three slots (the small-B plan's
    shapes), fill counts from lengths 0, 1, past U and past Lc, against
    the Pallas kernel in interpret mode at 1e-5."""
    rng = np.random.default_rng(40 + B)
    D, H = geo["d_model"], geo["num_heads"]
    U, R = geo["segment_length"], geo["right_context_length"]
    M, Lc = geo["max_memory_size"], geo["left_context_length"]
    use_mem = M > 0
    Q, K = R + U + (1 if use_mem else 0), M + R + Lc + U
    q = rng.standard_normal((B, Q, D)).astype(np.float32)
    k = rng.standard_normal((B, K, D)).astype(np.float32)
    v = rng.standard_normal((B, K, D)).astype(np.float32)
    length = np.array([1, U + 1, Lc + 3 * U][:B], np.int32)
    m_kv = np.minimum(Lc, length).astype(np.int32)
    m_m = (np.minimum(M, length // U) if use_mem
           else np.zeros(B)).astype(np.int32)
    kw = dict(num_heads=H, M=M, R=R, Lc=Lc, U=U, use_mem=use_mem,
              neg_inf=-1e8)
    want = fused_emformer_attention(*map(jnp.asarray, (q, k, v, m_m, m_kv)),
                                    interpret=True, **kw)
    got = emformer_attention(*map(torch.from_numpy, (q, k, v, m_m, m_kv)),
                             **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_stack_route_matches_jax_xla_path_at_few_slots(geo, B, dtype):
    """The stack route (kernel A's plain chain here) at one and three
    slots, with reset/advance churn over three steps, against JAX's XLA
    route at the JAX package's tolerances."""
    jcfg, tcfg, jparams, tparams, tol = _setup(geo, dtype, seed=41)
    xs, rs, adv = _inputs(geo, 3, B, seed=42 + B)
    want = _run_jax(jcfg, jparams, xs, rs, adv)
    got = _run_torch(te.emformer_stream_step,
                     dataclasses.replace(tcfg, route="stack"), tparams, xs,
                     rs, adv)
    _compare(got, want, tol)
