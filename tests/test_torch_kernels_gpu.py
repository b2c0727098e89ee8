"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips inside itself without a CUDA device.
Imports neither jax nor the JAX package, so on a machine with only
PyTorch it runs as
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu``.
Tolerances: f32 1e-4 (summation order only), bf16 3e-2 (the JAX
package's bf16 tolerance for its own kernel), the append and the row
top-k exact.
"""

import numpy as np
import pytest
import torch

from asr_streaming_tpu_torch.models import emformer as te
from asr_streaming_tpu_torch.ops import emformer_stack as es
from asr_streaming_tpu_torch.ops import emission_append as ea

VI = dict(d_model=64, num_heads=4, ffn_dim=96, num_layers=3,
          segment_length=8, left_context_length=16, right_context_length=2,
          max_memory_size=4)
EN = dict(VI, segment_length=4, left_context_length=10,
          right_context_length=1, max_memory_size=0)
# the English transcriber's own geometry (35 keys, 5 queries; Lc = 30 is
# no multiple of 8), at a narrow width
EN_FULL = dict(EN, left_context_length=30)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("geo", [VI, EN, EN_FULL],
                         ids=["vi_mem", "en_nomem", "en_lc30"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
def test_emformer_stack_kernel_matches_plain(geo, dtype, tol):
    dev = _cuda()
    cfg = te.EmformerConfig(**geo, compute_dtype=dtype)
    params = te.init_emformer_params(torch.Generator().manual_seed(0), cfg,
                                     dev)
    rng = np.random.default_rng(1)
    B, T = 6, cfg.segment_length + cfg.right_context_length
    state = te.init_emformer_state(cfg, B, dev)
    kw = dict(U=cfg.segment_length, R=cfg.right_context_length,
              M=cfg.max_memory_size, Lc=cfg.left_context_length,
              H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=dtype)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model)).astype(
            np.float32)).to(dev)
        r = torch.from_numpy(rng.random(B) < 0.3).to(dev)
        a = torch.from_numpy(rng.random(B) < 0.7).to(dev)
        eff = torch.where(r, torch.zeros_like(state.length), state.length)
        n0 = es.LAUNCHES
        got = es.emformer_stack(params, x, state.mem, state.lc_k, state.lc_v,
                                eff, r, a, **kw)
        assert es.LAUNCHES == n0 + 1
        want = es.emformer_stack_plain(params, x, state.mem, state.lc_k,
                                       state.lc_v, eff, r, a, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(g.float(), w.float(), rtol=tol,
                                       atol=tol)
        state = te.EmformerState(
            want[1], want[2], want[3],
            torch.where(a, eff + cfg.segment_length, eff).to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("U,V", [(16, 803), (4, 1024)],
                         ids=["vi_logprobs", "en_encodings"])
def test_emission_append_kernel_matches_plain_exactly(U, V):
    dev = _cuda()
    rng = np.random.default_rng(3)
    B, max_t = 16, 128
    buf = torch.from_numpy(rng.standard_normal((B, max_t, V)).astype(
        np.float16)).to(dev)
    rows = torch.from_numpy(rng.standard_normal((B, U, V)).astype(
        np.float32)).to(dev)
    pos = torch.from_numpy((rng.integers(0, max_t // U, B) * U).astype(
        np.int32)).to(dev)
    decode = torch.from_numpy(rng.integers(0, 2, B).astype(bool)).to(dev)
    n0 = ea.LAUNCHES
    got = ea.emission_append(buf.clone(), rows, pos, decode)
    assert ea.LAUNCHES == n0 + 1
    want = ea.emission_append_plain(buf.clone(), rows, pos, decode)
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("U,V", [(16, 803), (4, 1024), (3, 803), (5, 7),
                                 (1, 1)],
                         ids=["vi", "en", "misaligned", "narrow", "one"])
def test_emission_append_kernel_exact_at_any_offset(U, V):
    """Each slot's run starts at any offset (pos not a multiple of U, odd
    U * V: the source and the buffer 16-byte aligned at other values, or
    never), pos at 0 and at MAX_T - U, and out of range (no write)."""
    dev = _cuda()
    rng = np.random.default_rng(U * V)
    B, max_t = 24, 64
    buf = torch.from_numpy(rng.standard_normal((B, max_t, V)).astype(
        np.float16)).to(dev)
    rows = torch.from_numpy(rng.standard_normal((B, U, V)).astype(
        np.float32)).to(dev)
    pos = rng.integers(0, max_t - U + 1, B)
    pos[:4] = [0, max_t - U, -1, max_t - U + 1]
    pos = torch.from_numpy(pos.astype(np.int32)).to(dev)
    decode = torch.from_numpy(rng.random(B) < 0.8).to(dev)
    decode[:4] = True
    got = ea.emission_append(buf.clone(), rows, pos, decode)
    want = ea.emission_append_plain(buf.clone(), rows, pos, decode)
    assert torch.equal(got, want)
    assert torch.equal(got[2:4], buf[2:4])


def _routes(geo, dtype, dev, quant="none"):
    """The stack and layer routes of one config on the card, and the
    params they share."""
    base = te.EmformerConfig(**geo, compute_dtype=dtype, quant=quant)
    params = te.init_emformer_params(torch.Generator().manual_seed(4), base,
                                     dev)
    return base, params


def _step_both(cfg_a, cfg_b, params, dev, n_steps=3, B=6, seed=5):
    """Chained steps of two routes from one state stream; yields
    (tensors of a, tensors of b) per step."""
    rng = np.random.default_rng(seed)
    T = cfg_a.segment_length + cfg_a.right_context_length
    st_a = te.init_emformer_state(cfg_a, B, dev)
    st_b = te.init_emformer_state(cfg_b, B, dev)
    for _ in range(n_steps):
        x = torch.from_numpy(rng.standard_normal((B, T, cfg_a.d_model)).astype(
            np.float32)).to(dev)
        r = torch.from_numpy(rng.random(B) < 0.3).to(dev)
        a = torch.from_numpy(rng.random(B) < 0.7).to(dev)
        ya, st_a = te.emformer_stream_step(params, cfg_a, x, st_a, r, a)
        yb, st_b = te.emformer_stream_step(params, cfg_b, x, st_b, r, a)
        yield (ya, *st_a), (yb, *st_b)


@pytest.mark.gpu
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_layer_route_equals_stack_route_on_the_card(geo, dtype, quant):
    """Kernel C is one layer of kernel A's chain: bit for bit."""
    import dataclasses
    from asr_streaming_tpu_torch.ops import emformer_layer as el
    dev = _cuda()
    stack, params = _routes(geo, dtype, dev, quant)
    layer = dataclasses.replace(stack, route="layer")
    n0 = el.LAUNCHES
    for got, want in _step_both(layer, stack, params, dev):
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and torch.equal(g, w)
    assert el.LAUNCHES == n0 + 3 * geo["num_layers"]


@pytest.mark.gpu
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
@pytest.mark.parametrize("quant", ["int8", "int8_ffn"])
def test_emformer_stack_int8_kernel_matches_plain(geo, quant):
    """A's W8A8 mode vs its plain version: an int8 value flips where the
    kernel's and the plain version's f32 LN rows differ in the last bit
    and land on a rounding boundary, so the bound is the bf16 one, 3e-2."""
    dev = _cuda()
    cfg = te.EmformerConfig(**geo, compute_dtype=torch.bfloat16, quant=quant)
    params = te.init_emformer_params(torch.Generator().manual_seed(6), cfg,
                                     dev)
    rng = np.random.default_rng(7)
    B, T = 6, cfg.segment_length + cfg.right_context_length
    state = te.init_emformer_state(cfg, B, dev)
    kw = dict(U=cfg.segment_length, R=cfg.right_context_length,
              M=cfg.max_memory_size, Lc=cfg.left_context_length,
              H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=cfg.compute_dtype, quant=quant)
    for _ in range(3):
        x = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model)).astype(
            np.float32)).to(dev)
        r = torch.from_numpy(rng.random(B) < 0.3).to(dev)
        a = torch.from_numpy(rng.random(B) < 0.7).to(dev)
        eff = torch.where(r, torch.zeros_like(state.length), state.length)
        n0 = es.LAUNCHES_INT8
        got = es.emformer_stack(params, x, state.mem, state.lc_k, state.lc_v,
                                eff, r, a, **kw)
        assert es.LAUNCHES_INT8 == n0 + 1
        want = es.emformer_stack_plain(params, x, state.mem, state.lc_k,
                                       state.lc_v, eff, r, a, **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=3e-2,
                                       atol=3e-2)
        state = te.EmformerState(
            want[1], want[2], want[3],
            torch.where(a, eff + cfg.segment_length, eff).to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("x_f32", [True, False], ids=["x_f32", "x_cdt"])
def test_w8a8_product_matches_plain_exactly(dtype, x_f32):
    """The row quantiser and the int8 GEMM reproduce _qdot exactly: the
    same f32 operations in the same order, and an exact integer sum."""
    dev = _cuda()
    rng = np.random.default_rng(8)
    M, K, N = 300, 512, 192
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev)
    if not x_f32:
        x = x.to(dtype)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    q = es.quantized_weights({"w": w}, ["w"])["w"]
    got = es.w8a8_linear(x, q, bias, dtype)
    want = es._qdot(x.float(), q[0], q[1]).to(dtype) + bias.to(dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("use_mem", [True, False])
def test_emformer_attention_kernel_matches_plain(use_mem):
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    dev = _cuda()
    rng = np.random.default_rng(9)
    B, D, H, U, R, Lc = 5, 64, 4, 8, 2, 16
    M = 4 if use_mem else 0
    Q, K = R + U + (1 if use_mem else 0), M + R + Lc + U
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev) for s in ((B, Q, D), (B, K, D), (B, K, D)))
    length = torch.from_numpy(rng.integers(0, 40, B).astype(np.int32)).to(dev)
    m_kv = torch.clamp(length, max=Lc)
    m_m = torch.clamp(length // U, max=M) if use_mem else torch.zeros_like(length)
    kw = dict(num_heads=H, M=M, R=R, Lc=Lc, U=U, use_mem=use_mem)
    n0 = ek.LAUNCHES
    got = ek.emformer_attention(q, k, v, m_m, m_kv, **kw)
    assert ek.LAUNCHES == n0 + 1
    want = ek.emformer_attention_plain(q, k, v, m_m, m_kv, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,k", [
    ((64, 10, 4097), 10),     # the beam's per-hypothesis vocab rows
    ((64, 100), 10),          # its flat [B, W * kcap] table
    ((64, 50), 10),           # the end-of-frame table
    ((8, 4097), 128),         # the widest k
    ((5, 7, 130), 5),
], ids=["beam", "flat100", "flat50", "k128", "ragged"])
@pytest.mark.parametrize("kind", ["random", "ties", "sentinel", "neg_inf",
                                  "bf16"])
def test_row_topk_kernel_equals_iter_topk(shape, k, kind):
    """Kernel E == its plain version, values and indices, == the stable
    descending sort; on the card the dispatcher launches the kernel."""
    from asr_streaming_tpu_torch.ops import row_topk as rk
    from asr_streaming_tpu_torch.ops.topk import iter_topk, row_topk
    dev = _cuda()
    rng = np.random.default_rng(10)
    x = rng.standard_normal(shape).astype(np.float32)
    if kind == "ties":
        x = np.round(x * 2) / 2
    elif kind == "sentinel":
        x[rng.random(shape) < 0.95] = -1.0e30
        x[0] = -1.0e30
    elif kind == "neg_inf":
        x[rng.random(shape) < 0.5] = -np.inf
    xt = torch.from_numpy(x).to(dev)
    if kind == "bf16":
        xt = xt.to(torch.bfloat16)
    n0 = rk.LAUNCHES
    gv, gi = row_topk(xt, k)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == n0 + 1
    wv, wi = iter_topk(xt, k)
    assert gv.dtype == xt.dtype and gi.dtype == torch.int32
    assert torch.equal(gv, wv) and torch.equal(gi, wi)
    si = torch.sort(xt.float(), dim=-1, descending=True, stable=True)[1]
    assert torch.equal(gi.long(), si[..., :k])


def _row_case(case, rng):
    """(x on the CPU, k) of one edge case of kernel E's contract."""
    from asr_streaming_tpu_torch.ops import row_topk as rk
    if case == "k1":
        return torch.from_numpy(rng.standard_normal((64, 4097)).astype(
            np.float32)), 1
    if case.startswith("k_eq_n"):                  # k = N, narrow rows
        n = int(case[6:])
        x = np.round(rng.standard_normal((64, n)) * 2) / 2
        return torch.from_numpy(x.astype(np.float32)), n
    if case.startswith("width"):                   # N <= 32
        n = int(case[5:])
        x = rng.standard_normal((37, n)).astype(np.float32)
        return torch.from_numpy(x), min(n, 5)
    if case == "neg_inf_rows":                     # whole rows of -inf
        x = rng.standard_normal((48, 4097)).astype(np.float32)
        x[::3] = -np.inf
        x[1, 4000:] = -np.inf
        x[2, :4090] = -np.inf
        return torch.from_numpy(x), 10
    if case == "sentinel_rows":                    # whole rows of -1e30
        x = rng.standard_normal((48, 4097)).astype(np.float32)
        x[::2] = -1.0e30
        return torch.from_numpy(x), 10
    if case.startswith("kl"):                      # each list size, wide rows
        k = int(case[2:])
        x = rng.standard_normal((40, 1000)).astype(np.float32)
        return torch.from_numpy(x), k
    if case == "chunks":                           # rows of many chunks
        x = (rng.standard_normal((3, 100_003)) * 4).astype(np.float32)
        x[1] = np.round(x[1])
        return torch.from_numpy(x), 16
    if case == "max_n":
        x = rng.standard_normal((2, rk.MAX_N)).astype(np.float32)
        return torch.from_numpy(x), 10
    if case == "max_n_large_k":
        x = rng.standard_normal((2, rk.MAX_N_LARGE_K)).astype(np.float32)
        return torch.from_numpy(x), 20
    raise ValueError(case)


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [0, 1, 3], ids=["aligned", "off4", "off12"])
@pytest.mark.parametrize("case", [
    "k1", "k_eq_n40", "k_eq_n128", "width1", "width20", "width32",
    "neg_inf_rows",
    "sentinel_rows", "kl3", "kl5", "kl12", "kl16", "chunks", "max_n",
    "max_n_large_k"])
def test_row_topk_kernel_edge_rows(case, offset):
    """Kernel E == iter_topk (values and indices) on the contract's edges:
    k = 1, k = N, N <= 32, whole rows of -inf or of -1e30, each list size
    of the wide kernel, rows of several chunks, N at the wrapper's maxima;
    with the tensor's storage ``offset`` values in, so that no row starts
    16-byte aligned."""
    from asr_streaming_tpu_torch.ops import row_topk as rk
    from asr_streaming_tpu_torch.ops.topk import iter_topk
    dev = _cuda()
    x, k = _row_case(case, np.random.default_rng(14))
    flat = torch.empty(x.numel() + offset, device=dev)
    flat[offset:] = x.to(dev).reshape(-1)
    xt = flat[offset:].view(x.shape)
    assert xt.is_contiguous() and xt.data_ptr() % 16 == 4 * offset % 16
    n0 = rk.LAUNCHES
    gv, gi = rk.cuda_row_topk(xt, k)
    torch.cuda.synchronize()
    assert rk.LAUNCHES == n0 + 1
    wv, wi = iter_topk(xt, k)
    assert torch.equal(gv, wv) and torch.equal(gi, wi)


@pytest.mark.gpu
def test_row_topk_kernel_rejects_what_it_does_not_take():
    from asr_streaming_tpu_torch.ops import row_topk as rk
    dev = _cuda()
    x = torch.zeros((2, 300), device=dev)
    with pytest.raises(ValueError, match="k=129"):
        rk.cuda_row_topk(x, 129)
    with pytest.raises(ValueError, match="N=50 < k=60"):
        rk.cuda_row_topk(x[:, :50], 60)
    with pytest.raises(ValueError, match="N="):
        rk.cuda_row_topk(torch.zeros((1, rk.MAX_N + 1), device=dev), 4)
    with pytest.raises(ValueError, match="N="):
        rk.cuda_row_topk(torch.zeros((1, rk.MAX_N_LARGE_K + 1), device=dev), 17)


@pytest.mark.gpu
def test_beam_hash_wraps_on_the_card():
    """int32 products wrap on the card as numpy's two's complement."""
    from asr_streaming_tpu_torch.models import rnnt_beam as rb
    dev = _cuda()
    rng = np.random.default_rng(11)
    h = torch.full((512,), rb._HASH_INIT1, dtype=torch.int32, device=dev)
    want = np.full(512, rb._HASH_INIT1, np.int64)
    for _ in range(8):
        tok = rng.integers(0, 4097, 512).astype(np.int32)
        h = h * rb._HASH_M1 + (torch.from_numpy(tok).to(dev) + 1)
        want = (want * rb._HASH_M1 + tok + 1 + 2**31) % 2**32 - 2**31
    assert np.array_equal(h.cpu().numpy(), want.astype(np.int32))


# The ten bf16 products of one layer at the serving shapes, (rows, K, N,
# activation): VI (512 slots, Q = 21 queries, 24 key rows, 20 frames) and
# EN (512 slots, 5 queries = 5 key rows = 5 frames, no memory); D = 512,
# F = 2048, GELU after the first FFN product.
GEMM_SHAPES = {
    "vi_q": (10752, 512, 512, None), "vi_kv": (12288, 512, 1024, None),
    "vi_out": (10752, 512, 512, None), "vi_ffn1": (10240, 512, 2048, "gelu"),
    "vi_ffn2": (10240, 2048, 512, None),
    "en_q": (2560, 512, 512, None), "en_kv": (2560, 512, 1024, None),
    "en_out": (2560, 512, 512, None), "en_ffn1": (2560, 512, 2048, "gelu"),
    "en_ffn2": (2560, 2048, 512, None),
    # ragged: rows, K and N off every tile edge
    "ragged": (300, 200, 136, None),
    "relu": (333, 512, 264, "relu"), "gelu": (333, 512, 264, "gelu"),
    "silu": (333, 512, 264, "silu"),
}


def _check_gemm(dev, M, K, N, act, config=None):
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    got = es.gemm_bf16(x, w, bias, act, config)
    torch.cuda.synchronize()
    want = es.gemm_bf16_plain(x, w, bias, act)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.isfinite(got.float()).all()
    bound = es.gemm_bf16_error_bound(x, w, want, act)
    err = (got.float() - want.float()).abs()
    assert bool((err <= bound).all()), (
        f"{int((err > bound).sum())} of {err.numel()} beyond the bound, "
        f"max {float((err / bound).max()):.2f} x the bound")


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GEMM_SHAPES))
def test_gemm_bf16_matches_plain_within_its_bound(name):
    """The wgmma GEMM against ``_mm`` + ``epilogue<bf16>``: only the f32
    sum order differs, so the product rounded to bf16 lands at most one
    ulp away, carried through the bias and the activation as
    ``gemm_bf16_error_bound`` states."""
    _check_gemm(_cuda(), *GEMM_SHAPES[name])


@pytest.mark.gpu
@pytest.mark.parametrize("config", range(len(es.GEMM_TILES)),
                         ids=[f"{m}x{n}" for m, n in es.GEMM_TILES])
@pytest.mark.parametrize("name", ["ragged", "gelu", "relu", "silu", "en_q",
                                  "en_ffn1", "vi_ffn2"])
def test_gemm_bf16_each_tile_matches_plain(name, config):
    """Each tile configuration, forced, within the same bound: ragged
    edges, each activation through the ping-pong epilogue, and serving
    shapes of one, a few and many tiles a warpgroup."""
    _check_gemm(_cuda(), *GEMM_SHAPES[name], config=config)


# the ten serving shapes and a ragged one: every tile, forced, gives the
# bits of the tile the chain picks
BIT_SHAPES = [n for n in GEMM_SHAPES if n[:3] in ("vi_", "en_")] + ["ragged"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", BIT_SHAPES)
def test_gemm_bf16_every_tile_gives_the_picked_tiles_bits(name):
    """Each output's sum runs over the same wgmma k steps in the same
    order on every tile, and the epilogue rounds at the same points, so
    the bf16 product does not depend on the tile: each forced tile equals
    the picked one bit for bit (a second call too)."""
    dev = _cuda()
    M, K, N, act = GEMM_SHAPES[name]
    rng = np.random.default_rng(13)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(
        np.float32)).to(dev).to(torch.bfloat16)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(
        dev).to(torch.bfloat16)
    picked = es.gemm_bf16(x, w, bias, act)
    assert torch.equal(es.gemm_bf16(x, w, bias, act), picked)
    for config in range(len(es.GEMM_TILES)):
        got = es.gemm_bf16(x, w, bias, act, config)
        torch.cuda.synchronize()
        assert torch.equal(got, picked), (
            f"{es.GEMM_TILES[config]}: {int((got != picked).sum())} of "
            f"{got.numel()} differ from the picked tile's")


@pytest.mark.gpu
def test_gemm_config_takes_the_least_load_and_fills_the_card_at_en():
    """The tile picked for each product (bf16 and int8 sums alike), and for
    a layer's q and kv in one launch, is the one whose busiest SM loads
    the fewest bytes (rounds of tiles over the SMs times a tile's rows and
    columns; the larger tile on a tie).  At the EN shape (2,560 rows)
    that puts a tile on every SM for the q + kv launch (240 tiles of
    128x128) and for ffn1, where 128x128 tiles of q alone would leave 52
    of 132 SMs idle."""
    _cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    configs = range(len(es.GEMM_TILES))
    for name, (M, K, N, _) in GEMM_SHAPES.items():
        spans = [es.gemm_load_span([(M, N)], c, sms) for c in configs]
        assert es.gemm_config(M, N) == spans.index(min(spans)), name
    for lang in ("vi", "en"):
        (Mq, K, Nq, _), (Mkv, _, Nkv, _) = (GEMM_SHAPES[f"{lang}_q"],
                                            GEMM_SHAPES[f"{lang}_kv"])
        spans = [es.gemm_load_span([(Mq, Nq), (Mkv, Nkv)], c, sms)
                 for c in configs]
        c = es.gemm_config(Mq, Nq, pair=(Mkv, Nkv))
        assert c == spans.index(min(spans)), (lang, spans)
        if lang == "en":
            wm, bn = es.GEMM_TILES[c]
            tiles = sum(-(-M // wm) * -(-N // bn)
                        for M, N in ((Mq, Nq), (Mkv, Nkv)))
            assert tiles >= sms, (es.GEMM_TILES[c], tiles)
            wq, bq = es.GEMM_TILES[es.gemm_config(Mq, Nq)]
            assert -(-Mq // wq) * -(-Nq // bq) < sms
    M, K, N, _ = GEMM_SHAPES["en_ffn1"]
    wm, bn = es.GEMM_TILES[es.gemm_config(M, N)]
    assert -(-M // wm) * -(-N // bn) >= sms


# a layer's q and kv products in one launch: VI, EN and a ragged pair
PAIR_SHAPES = {
    "vi": ((10752, 512), (12288, 1024), 512),
    "en": ((2560, 512), (2560, 1024), 512),
    "ragged": ((300, 136), (84, 264), 200),
}


@pytest.mark.gpu
@pytest.mark.parametrize("config", [None] + list(range(len(es.GEMM_TILES))),
                         ids=["picked"] + [f"{m}x{n}"
                                           for m, n in es.GEMM_TILES])
@pytest.mark.parametrize("name", list(PAIR_SHAPES))
def test_gemm_bf16_pair_equals_two_launches(name, config):
    """The q + kv launch (one list of both products' tiles) gives each
    product's bits as its own launch does."""
    dev = _cuda()
    (M0, N0), (M1, N1), K = PAIR_SHAPES[name]
    rng = np.random.default_rng(17)

    def operands(M, N):
        x = torch.from_numpy(rng.standard_normal((M, K)).astype(
            np.float32)).to(dev).to(torch.bfloat16)
        w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K))
                             .astype(np.float32)).to(dev).to(torch.bfloat16)
        b = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(
            dev).to(torch.bfloat16)
        return x, w, b

    a, b = operands(M0, N0), operands(M1, N1)
    y0, y1 = es.gemm_bf16_pair(*a, *b, config=config)
    torch.cuda.synchronize()
    assert torch.equal(y0, es.gemm_bf16(*a))
    assert torch.equal(y1, es.gemm_bf16(*b))


@pytest.mark.gpu
@pytest.mark.parametrize("act", ["gelu", "silu"])
def test_gemm_activation_equals_its_table_on_every_bf16_value(act):
    """The epilogue's GELU and SiLU (the table's serving range from
    shared memory, the rest from device memory) give the table's bits,
    the bits of activate() rounded, for every bf16 input: a product of
    zero rows whose bias holds all 65,536 bit patterns (the
    pre-activation is the bias itself; -0.0 becomes +0.0), on each
    tile."""
    dev = _cuda()
    N, K = 65536, 64
    bias = torch.arange(-32768, 32768, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).to(dev)
    x = torch.zeros(64, K, dtype=torch.bfloat16, device=dev)
    w = torch.zeros(K, N, dtype=torch.bfloat16, device=dev)
    table = es.gemm_act_table(act, dev).long() & 0xffff
    pre = (torch.zeros_like(bias) + bias).view(torch.int16).long() & 0xffff
    want = table[pre]
    for config in [None] + list(range(len(es.GEMM_TILES))):
        got = es.gemm_bf16(x, w, bias, act, config)
        torch.cuda.synchronize()
        bits = got.view(torch.int16).long() & 0xffff
        bad = (bits != want[None]).nonzero()
        assert bad.numel() == 0, (
            f"{config}: {bad.shape[0]} outputs differ, first input bits "
            f"{int(pre[bad[0, 1]]):#06x}: {int(bits[tuple(bad[0])]):#06x} "
            f"against {int(want[bad[0, 1]]):#06x}")


@pytest.mark.gpu
def test_gemm_main_loop_only_leaves_the_output_unwritten():
    """``main_loop_only`` (timing) launches the same GEMM without its
    epilogue: nothing is written, and the next full call is exact."""
    dev = _cuda()
    M, K, N, act = GEMM_SHAPES["gelu"]
    x = torch.randn(M, K, device=dev).to(torch.bfloat16)
    w = (torch.randn(K, N, device=dev) / K ** 0.5).to(torch.bfloat16)
    bias = torch.randn(N, device=dev).to(torch.bfloat16)
    want = es.gemm_bf16(x, w, bias, act)
    wt = es._kernel_tensor(w, torch.bfloat16, transpose=True)
    y = torch.full((M, N), 7.0, dtype=torch.bfloat16, device=dev)
    from asr_streaming_tpu_torch.ops import _cuda as cu
    cu.launch(dev, "asr_gemm_bf16", "gemm_bf16", x.data_ptr(), wt.data_ptr(),
              bias.data_ptr(), y.data_ptr(), M, N, K, es._MAIN_LOOP_ONLY, -1,
              torch.cuda.current_stream(dev).cuda_stream)
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())
    assert torch.equal(es.gemm_bf16(x, w, bias, act), want)
    with pytest.raises(ValueError, match="main_loop_only"):
        es.gemm_bf16(x.cpu(), w.cpu(), bias.cpu(), act, main_loop_only=True)


# A's f32 products: the offline API's five at B = 1 and B = 3 (the
# split-K kernel), a 512-slot one (tiled), ragged ones (N and K off the
# tile and slice edges; N % 4 = 2, tiled) and each activation
GEMM_F32_SHAPES = {
    "b1_q": (21, 512, 512, None), "b1_kv": (24, 512, 1024, None),
    "b1_ffn1": (20, 512, 2048, "gelu"), "b1_ffn2": (20, 2048, 512, None),
    "b3_kv": (72, 512, 1024, None), "b3_ffn2": (60, 2048, 512, None),
    "slots512_q": (10752, 512, 512, None),
    "ragged": (37, 200, 136, None), "ragged_tiled": (30, 202, 130, None),
    "rows128": (128, 2048, 512, "relu"), "silu": (45, 512, 264, "silu"),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(GEMM_F32_SHAPES))
def test_gemm_f32_matches_plain_within_its_bound(name):
    """The f32 product against ``gemm_f32_plain`` summed in the kernel's
    K-slice order, within ``gemm_f32_error_bound`` (only the f32 sum order
    differs); a second call equal bit for bit (the split-K reduction is
    deterministic); the tiled kernel forced within the same bound."""
    dev = _cuda()
    M, K, N, act = GEMM_F32_SHAPES[name]
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((M, K)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    want = es.gemm_f32_plain(x, w, bias, act,
                             splits=es.gemm_f32_config(M, N, K))
    bound = es.gemm_f32_error_bound(x, w, want, act)
    got = es.gemm_f32(x, w, bias, act)
    assert torch.equal(es.gemm_f32(x, w, bias, act), got)
    for y in (got, es.gemm_f32(x, w, bias, act, 0)):
        torch.cuda.synchronize()
        assert y.dtype == torch.float32 and y.shape == (M, N)
        assert torch.isfinite(y).all()
        err = (y - want).abs()
        assert bool((err <= bound).all()), (
            f"{int((err > bound).sum())} of {err.numel()} beyond the bound, "
            f"max {float((err / bound).max()):.2f} x the bound")


@pytest.mark.gpu
@pytest.mark.parametrize("K,N", [(512, 512), (512, 1024), (512, 2048),
                                 (2048, 512)])
def test_gemm_f32_rows_do_not_depend_on_the_rows_beside_them(K, N):
    """The split depends on (N, K) only: the first 21 rows of a 63- and
    a 128-row product equal the 21-row product bit for bit."""
    dev = _cuda()
    rng = np.random.default_rng(19)
    x = torch.from_numpy(rng.standard_normal((128, K)).astype(np.float32)).to(dev)
    w = torch.from_numpy((rng.standard_normal((K, N)) / np.sqrt(K)).astype(
        np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    one = es.gemm_f32(x[:21], w, bias, "gelu")
    for rows in (63, 128):
        assert torch.equal(es.gemm_f32(x[:rows], w, bias, "gelu")[:21], one)


@pytest.mark.gpu
def test_emformer_stack_f32_slot_bits_do_not_depend_on_the_batch():
    """Slot 0 of a B = 3 f32 step equals a B = 1 step of that slot, bit
    for bit (the offline API's batch; every product on the split-K
    kernel)."""
    dev = _cuda()
    cfg = te.EmformerConfig(**VI, compute_dtype=torch.float32)
    params = te.init_emformer_params(torch.Generator().manual_seed(0), cfg,
                                     dev)
    rng = np.random.default_rng(23)
    B, T = 3, cfg.segment_length + cfg.right_context_length
    st = te.init_emformer_state(cfg, B, dev)
    mem, lck, lcv = (torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(
        np.float32)).to(dev) for t in (st.mem, st.lc_k, st.lc_v))
    x = torch.from_numpy(rng.standard_normal((B, T, cfg.d_model)).astype(
        np.float32)).to(dev)
    length = torch.tensor([9, 20, 3], dtype=torch.int32, device=dev)
    kw = dict(U=cfg.segment_length, R=cfg.right_context_length,
              M=cfg.max_memory_size, Lc=cfg.left_context_length,
              H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=torch.float32)
    three = es.emformer_stack(params, x, mem, lck, lcv, length, **kw)
    one = es.emformer_stack(params, x[:1], mem[:, :1], lck[:, :1],
                            lcv[:, :1], length[:1], **kw)
    assert torch.equal(three[0][:1], one[0])
    for a, b in zip(three[1:], one[1:]):
        assert torch.equal(a[:, :1], b)


# The W8A8 products: the ten serving shapes, a ragged one (K = 208, no
# multiple of 128), the tiny geometry of these tests (d_model 64, ffn 96,
# kv 128) and each activation.
INT8_SHAPES = {n: s for n, s in GEMM_SHAPES.items() if n[:3] in ("vi_", "en_")}
INT8_SHAPES.update({
    "ragged": (300, 208, 136, None),
    "tiny_q": (66, 64, 64, None), "tiny_kv": (84, 64, 128, None),
    "tiny_ffn1": (60, 64, 96, "gelu"), "tiny_ffn2": (60, 96, 64, None),
    "relu": (333, 512, 264, "relu"), "silu": (333, 512, 264, "silu"),
})


def _check_int8(dev, M, K, N, act, dtype, config):
    """The int8 wgmma GEMM == _qdot(...).to(dtype) + bias bit for bit (an
    exact s32 sum, the same f32 dequant); with an activation, the kernel's
    result is that exact value through the activation, held to torch's
    within one ulp of the output type (the two compute GELU and SiLU in
    f32 with other operation orders)."""
    rng = np.random.default_rng(15)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 2).astype(
        np.float32)).to(dev)
    w = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)).to(dev)
    bias = torch.from_numpy(rng.standard_normal(N).astype(np.float32)).to(dev)
    q = es.quantized_weights({"w": w}, ["w"])["w"]
    got = es.w8a8_linear(x, q, bias, dtype, None, config)
    torch.cuda.synchronize()
    want = es._qdot(x, q[0], q[1]).to(dtype) + bias.to(dtype)
    assert got.dtype == dtype and got.shape == (M, N)
    assert torch.equal(got, want), (
        f"{int((got != want).sum())} of {got.numel()} differ")
    if act:
        got_act = es.w8a8_linear(x, q, bias, dtype, act, config)
        ref = es._act(act)(want)
        tol = dict(rtol=2 ** -7, atol=1e-6) if dtype == torch.bfloat16 \
            else dict(rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got_act.float(), ref.float(), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("config", [None] + list(range(len(es.GEMM_TILES))),
                         ids=["picked"] + [f"{m}x{n}"
                                           for m, n in es.GEMM_TILES])
@pytest.mark.parametrize("name", list(INT8_SHAPES))
def test_w8a8_gemm_equals_qdot_on_each_tile(name, config, dtype):
    """A-int8's GEMM at every serving shape, on the tile run_layer picks
    and on each tile forced, with bf16 and f32 outputs."""
    _check_int8(_cuda(), *INT8_SHAPES[name], dtype, config)


@pytest.mark.gpu
def test_w8a8_config_fills_the_card():
    """The tile picked for each W8A8 serving product is a valid index, and
    at the EN shape ffn1 puts a tile on every SM."""
    _cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (M, K, N, _) in INT8_SHAPES.items():
        c = es.gemm_config(M, N)
        assert c in range(len(es.GEMM_TILES))
        if name == "en_ffn1":
            wm, bn = es.GEMM_TILES[c]
            assert -(-M // wm) * -(-N // bn) >= sms, (name, es.GEMM_TILES[c])


@pytest.mark.gpu
def test_w8a8_linear_rejects_what_it_does_not_take():
    dev = _cuda()
    w = torch.randn(64, 60, device=dev)
    q = es.quantized_weights({"w": w}, ["w"])["w"]
    with pytest.raises(ValueError, match="N of 8"):
        es.w8a8_linear(torch.randn(4, 64, device=dev), q,
                       torch.zeros(60, device=dev), torch.bfloat16)
    q = es.quantized_weights({"w": w[:, :56]}, ["w"])["w"]
    with pytest.raises(ValueError, match=f"config {len(es.GEMM_TILES)}"):
        es.w8a8_linear(torch.randn(4, 64, device=dev), q,
                       torch.zeros(56, device=dev), torch.bfloat16,
                       config=len(es.GEMM_TILES))


@pytest.mark.gpu
@pytest.mark.parametrize("use_mem", [True, False], ids=["vi_mem", "en_nomem"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16],
                         ids=["out_f32", "out_bf16"])
def test_emformer_attention_bf16_inputs_equal_widened_f32(use_mem, out_dtype):
    """D on bf16 q/k/v is D on their exact f32 widening, bit for bit, and
    a bf16 output is that f32 output rounded once; at the serving widths
    (D = 512, H = 8) and key counts (VI: Q = 21, K = 56; EN: Q = 5,
    K = 35)."""
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    dev = _cuda()
    rng = np.random.default_rng(13)
    B, D, H = 64, 512, 8
    U, R, Lc, M = (16, 4, 32, 4) if use_mem else (4, 1, 30, 0)
    Q, K = R + U + (1 if use_mem else 0), M + R + Lc + U
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        dev).to(torch.bfloat16) for s in ((B, Q, D), (B, K, D), (B, K, D)))
    length = torch.from_numpy(rng.integers(0, 200, B).astype(np.int32)).to(dev)
    m_kv = torch.clamp(length, max=Lc)
    m_m = torch.clamp(length // U, max=M)
    kw = dict(num_heads=H, M=M, R=R, Lc=Lc, U=U, use_mem=use_mem)
    n0 = ek.LAUNCHES
    got = ek.emformer_attention(q, k, v, m_m, m_kv, out_dtype=out_dtype, **kw)
    wide = ek.emformer_attention(q.float(), k.float(), v.float(), m_m, m_kv,
                                 **kw)
    assert ek.LAUNCHES == n0 + 2
    assert got.dtype == out_dtype and torch.equal(got, wide.to(out_dtype))
    want = ek.emformer_attention_plain(q, k, v, m_m, m_kv, out_dtype=out_dtype,
                                       **kw)
    tol = 1e-4 if out_dtype == torch.float32 else 8e-3
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
def test_sharded_step_on_two_cards_equals_one_card():
    """The VI tick (kernels A and B) split over the first two cards
    (parallel/serving.py) equals the tick on one card: the pack exactly,
    the carried f32 state within 1e-4; each card launches its shard's
    kernels."""
    _cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from asr_streaming_tpu_torch.models import asr as ta
    from asr_streaming_tpu_torch.models import serving as ts
    from asr_streaming_tpu_torch.ops import _cuda as cu
    from asr_streaming_tpu_torch.parallel import serving as ps
    cfg = ts.ServingConfig(asr=ta.ASRConfig.tiny(vocab_size=21),
                           use_silero=False, max_emission_frames=64)
    B, dev = 8, torch.device("cuda", 0)
    params = ts.init_serving_params(0, cfg, dev)
    mesh = ps.make_serving_mesh(2)
    step = ps.make_sharded_stepper(cfg, mesh, params)
    full = (ts.init_serving_state(cfg, B, dev),
            ts.init_audio_context(cfg, B, dev),
            ts.init_emission_buffer(cfg, B, dev))
    sharded = ps.shard_serving_arrays(
        cfg, mesh, ts.init_serving_state(cfg, B, dev),
        ts.init_audio_context(cfg, B, dev),
        ts.init_emission_buffer(cfg, B, dev))
    rng = np.random.default_rng(0)
    before = dict(cu.DEVICE_LAUNCHES)
    for tick in range(3):
        seg = torch.from_numpy(rng.integers(
            -3000, 3000, (B, cfg.asr.audio.segment_length)).astype(np.int16))
        flags = [torch.from_numpy(f) for f in (
            rng.random(B) < 0.3, np.ones(B, bool), np.full(B, tick == 0),
            np.full(B, tick == 0) | (np.arange(B) == 5))]
        want = ts.serving_step(params, cfg, seg.to(dev),
                               *(f.to(dev) for f in flags), *full)
        full = (want.state, want.ctx, want.emission)
        got = step(step.params, cfg, ps.split_rows(seg.pin_memory(), mesh),
                   *(ps.split_rows(f.pin_memory(), mesh) for f in flags),
                   *sharded)
        sharded = (got.state, got.ctx, got.emission)
        assert [p.device.index for p in got.pack] == [0, 1]
        assert torch.equal(ps.join_shards(got.pack, 0, dev), want.pack)
        state = ps.join_shards(got.state, ps.serving_state_slot_axes(cfg),
                               dev)
        for a, b in zip(state, want.state):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    for ordinal in (0, 1):
        assert cu.DEVICE_LAUNCHES.get(ordinal, 0) > before.get(ordinal, 0)


@pytest.mark.gpu
@pytest.mark.parametrize("wrapper", ["stack", "layer", "attention", "append",
                                     "row_topk", "gemm_bf16", "gemm_f32"])
def test_kernels_refuse_a_call_autograd_would_record(wrapper):
    """Fault 16: a kernel has no backward, so with gradients on and an
    input that requires grad the wrapper raises before it launches; under
    torch.no_grad the same call runs."""
    from asr_streaming_tpu_torch.ops import _cuda as kernels
    from asr_streaming_tpu_torch.ops.emformer_attention import (
        emformer_attention,
    )
    from asr_streaming_tpu_torch.ops.emformer_layer import emformer_layer
    from asr_streaming_tpu_torch.ops.row_topk import cuda_row_topk
    dev = _cuda()
    cfg = te.EmformerConfig(**VI)
    params = te.init_emformer_params(torch.Generator().manual_seed(0), cfg,
                                     dev)
    B, U, R, D = 2, cfg.segment_length, cfg.right_context_length, 64
    M, Lc = cfg.max_memory_size, cfg.left_context_length
    state = te.init_emformer_state(cfg, B, dev)
    kw = dict(U=U, R=R, M=M, Lc=Lc, H=4, use_mem=True, tanh_on_mem=True,
              neg_inf=-1e8, activation="gelu", cdt=torch.float32)
    x = torch.randn((B, U + R, D), device=dev)
    grad_params = {k: v.clone().requires_grad_(True)
                   for k, v in params.items()}

    def call(p, xx):
        if wrapper == "stack":
            return es.emformer_stack(p, xx, state.mem, state.lc_k,
                                     state.lc_v, state.length, **kw)
        if wrapper == "layer":
            return emformer_layer({k: v[0] for k, v in p.items()},
                                  xx[:, :U], xx[:, U:], None, state.mem[0],
                                  state.lc_k[0], state.lc_v[0],
                                  state.length, **kw)
        if wrapper == "attention":
            K, Q = M + R + Lc + U, R + U + 1
            q = xx.new_zeros((B, Q, D)) + xx.sum()
            k = torch.zeros((B, K, D), device=dev)
            return emformer_attention(q, k, k, state.length, state.length,
                                      num_heads=4, M=M, R=R, Lc=Lc, U=U)
        if wrapper == "append":
            buf = torch.zeros((B, 32, D), dtype=torch.float16, device=dev)
            return ea.emission_append(buf, xx[:, :U], state.length,
                                      torch.ones(B, dtype=torch.bool,
                                                 device=dev))
        if wrapper == "row_topk":
            return cuda_row_topk(xx.reshape(-1, D), 4)
        if wrapper == "gemm_f32":
            return es.gemm_f32(xx.reshape(-1, D), p["w_q"][0], p["b_q"][0])
        return es.gemm_bf16(xx.reshape(-1, D), p["w_q"][0], p["b_q"][0])

    before = kernels.launch_counts()
    with pytest.raises(RuntimeError, match="no backward"):
        call(grad_params if wrapper in ("stack", "layer", "gemm_bf16",
                                        "gemm_f32")
             else params, x.clone().requires_grad_(True))
    assert kernels.launch_counts() == before
    with torch.no_grad():
        call(grad_params, x.clone().requires_grad_(True))
    torch.cuda.synchronize()


# A's row kernels alone (``es.rows_*``, entry asr_emformer_rows): B, D, U,
# R, M, Lc and the compute type of the VI and EN serving steps, the offline
# API's B = 1 f32 step, the tiny geometry, and a narrow f32 one (D = 36:
# nine 16-byte vectors a row, no row a multiple of 128 bytes, Lc < U)
ROW_SHAPES = {
    "vi": (512, 512, 16, 4, 4, 32, torch.bfloat16),
    "en": (512, 512, 4, 1, 0, 30, torch.bfloat16),
    "b1_f32": (1, 512, 16, 4, 4, 32, torch.float32),
    "tiny": (6, 64, 8, 2, 4, 16, torch.bfloat16),
    "narrow_f32": (5, 36, 3, 2, 2, 2, torch.float32),
}


def _row_calls(shape, dev, seed=31):
    """{kind: (kernel wrapper, plain version, args, kwargs, output names,
    outputs equal bit for bit)} on seeded inputs on ``dev``."""
    B, D, U, R, M, Lc, cdt = shape
    T, use_mem = U + R, M > 0
    Q = T + int(use_mem)
    rng = np.random.default_rng(seed)

    def normal(*s, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(s).astype(
            np.float32)).to(device=dev, dtype=dtype)

    reset = torch.from_numpy(rng.random(B) < 0.2).to(dev)
    advance = torch.from_numpy(rng.random(B) < 0.8).to(dev)
    ln = [(1 + normal(D, scale=0.1), normal(D, scale=0.1)) for _ in range(3)]
    mem = normal(B, M, D, dtype=cdt)
    memrow = normal(B, D).tanh()
    out, hin = normal(B, Q, D, dtype=cdt), normal(B, T, D)
    h2 = normal(B, T, D, dtype=cdt)
    g = dict(U=U, R=R, use_mem=use_mem)
    return {
        "first": (es.rows_first, es.rows_first_plain,
                  (normal(B, T, D), mem, reset, advance, *ln[0], memrow),
                  dict(g, cdt=cdt),
                  ("hin", "q_in", "kv_in", "q8", "memrow", "mem"),
                  ("hin", "memrow", "mem")),
        "residual": (es.rows_residual, es.rows_residual_plain,
                     (out, hin, normal(B, M + T, 2 * D, dtype=cdt),
                      normal(B, Lc, D, dtype=cdt), normal(B, Lc, D, dtype=cdt),
                      reset, advance, *ln[1]),
                     dict(U=U, R=R, M=M, Lc=Lc, use_mem=use_mem,
                          tanh_on_mem=True),
                     ("ff_in", "q8", "memrow", "lc_k", "lc_v"),
                     ("lc_k", "lc_v")),
        "boundary": (es.rows_boundary, es.rows_boundary_plain,
                     (out, hin, h2, mem, memrow, reset, advance, *ln[2],
                      *ln[0]), g,
                     ("hin", "q_in", "kv_in", "q8", "mem"), ("mem",)),
        "last": (es.rows_last, es.rows_last_plain,
                 (out, hin, h2, *ln[2]), dict(U=U, R=R), ("hin", "y"), ()),
    }, M


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["first", "residual", "boundary", "last"])
@pytest.mark.parametrize("shape", list(ROW_SHAPES))
def test_row_kernel_matches_plain(shape, kind):
    """The roll's rows (the rolled state, kv_in's memory rows) and the
    chunk's copy bit for bit; LN outputs, the summary and the memory row
    within f32 rounding (f32 1e-4; the compute type one of its ulps, rtol
    2^-7); the inputs are left as they were."""
    dev = _cuda()
    calls, M = _row_calls(ROW_SHAPES[shape], dev)
    kernel, plain, args, kw, names, exact = calls[kind]
    before = [a.clone() for a in args if isinstance(a, torch.Tensor)]
    got = kernel(*args, **kw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(
        [a for a in args if isinstance(a, torch.Tensor)], before))
    want = plain(*args, **kw)
    for name, g, w in zip(names, got, want):
        if w is None or name == "q8":
            assert g == w, name
            continue
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name in exact:
            assert torch.equal(g, w), name
            continue
        if name == "kv_in":
            assert torch.equal(g[:, :M], w[:, :M]), name
        rtol = 1e-4 if g.dtype == torch.float32 else 2.0 ** -7
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=1e-4,
                                   msg=name)


def _widened(args, kw):
    """The same row kernel call in f32: floating inputs widened, so that
    its f32 rows hold the values the compute-type call rounds (its LN
    reads the inputs as f32 either way)."""
    wide = [a.float() if isinstance(a, torch.Tensor) and a.is_floating_point()
            else a for a in args]
    return wide, dict(kw, cdt=torch.float32) if "cdt" in kw else kw


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["first", "residual", "boundary"])
@pytest.mark.parametrize("shape", list(ROW_SHAPES))
def test_row_kernel_int8_rows_are_its_rows_quantised(shape, kind):
    """In W8A8 a row kernel writes q's, kv's and ffn1's int8 rows and
    scales in place of their compute-type rows: bit for bit
    ``quantize_rows_plain`` (_qdot's quantisation) of the rows the same
    kernel makes unquantised (q and ffn1: its f32 rows, from the same call
    in f32; kv: its compute-type rows), every other output bit for bit the
    unquantised call's; against the plain version's int8 rows (whose f32
    LN differs in the last bits) within one step, the scales within the
    tolerance of the rows they come from (f32 1e-4, the compute type
    2^-7)."""
    dev = _cuda()
    calls, _ = _row_calls(ROW_SHAPES[shape], dev)
    kernel, plain, args, kw, names, _ = calls[kind]
    got = kernel(*args, **kw, quant="int8")
    own = kernel(*args, **kw)
    wide_args, wide_kw = _widened(args, kw)
    wide = kernel(*wide_args, **wide_kw)
    torch.cuda.synchronize()
    want = plain(*args, **kw, quant="int8")
    slot = names.index("q8")
    q8, q8_plain = got[slot], want[slot]
    sources = ({"ff_w1": wide[0]} if kind == "residual"
               else {"w_q": wide[1], "w_kv": own[2]})
    assert set(q8) == set(q8_plain) == set(sources)
    for name, (xq, s) in q8.items():
        want_q, want_s = es.quantize_rows_plain(sources[name])
        assert torch.equal(xq, want_q) and torch.equal(s, want_s), name
        pq, ps = q8_plain[name]
        assert (xq.int() - pq.int()).abs().max() <= 1, name
        rtol = 2.0 ** -7 if name == "w_kv" and \
            own[2].dtype == torch.bfloat16 else 1e-4
        torch.testing.assert_close(s, ps, rtol=rtol, atol=0, msg=name)
    for name, g, o in zip(names, got, own):
        if name in ("q_in", "kv_in", "ff_in"):
            assert g is None, name
        elif name != "q8" and o is not None:
            assert torch.equal(g, o), name


# out's and ffn2's rows at the serving shapes (bf16, the compute type),
# f32 rows, a ragged K (no multiple of 32 chunks), K past a warp's
# registers (the scalar path), and a row that starts 2 bytes off 16
QUANT_SHAPES = {
    "vi_out": (10752, 512, torch.bfloat16, 0),
    "vi_ffn2": (10240, 2048, torch.bfloat16, 0),
    "en_out": (2560, 512, torch.bfloat16, 0),
    "en_ffn2": (2560, 2048, torch.bfloat16, 0),
    "f32_512": (333, 512, torch.float32, 0),
    "f32_2048": (77, 2048, torch.float32, 0),
    "ragged": (300, 208, torch.bfloat16, 0),
    "wide": (40, 4096, torch.bfloat16, 0),
    "misaligned": (50, 512, torch.bfloat16, 1),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(QUANT_SHAPES))
def test_quantize_rows_kernel_equals_plain(name):
    """The W8A8 row quantiser (``quantize_rows``) gives
    ``quantize_rows_plain``'s int8 rows and scales (_qdot's, which the CPU
    tests hold to the JAX package's) bit for bit, with an all-zero row
    and a row whose amax is negative."""
    dev = _cuda()
    M, K, dtype, offset = QUANT_SHAPES[name]
    rng = np.random.default_rng(M + K)
    x = torch.from_numpy((rng.standard_normal((M, K)) * 3).astype(
        np.float32)).to(dtype)
    x[1] = 0
    x[2, K // 3] = -50
    x = torch.cat([torch.zeros(offset, dtype=dtype), x.reshape(-1)]).to(
        dev)[offset:].view(M, K)
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    xq, s = es.quantize_rows(x)
    torch.cuda.synchronize()
    want_q, want_s = es.quantize_rows_plain(x)
    assert torch.equal(xq, want_q) and torch.equal(s, want_s)
    assert not xq[1].any() and xq[2, K // 3] == -127


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["bf16_d36", "misaligned"])
def test_row_kernels_refuse_what_16_byte_vectors_cannot_cover(case,
                                                              monkeypatch):
    """The roll copies only 16-byte vectors: a bf16 D = 36 (four and a half
    a row) or a left context that starts 2 bytes off is refused by the
    wrapper, and by the C entry itself when the wrapper's check is
    skipped."""
    dev = _cuda()
    shape = (4, 36 if case == "bf16_d36" else 64, 8, 2, 4, 16,
             torch.bfloat16)
    calls, _ = _row_calls(shape, dev)
    kernel, _, args, kw, *_ = calls["residual"]
    args = list(args)
    if case == "misaligned":
        lc = args[3]
        args[3] = torch.zeros(lc.numel() + 1, dtype=lc.dtype,
                              device=dev)[1:].view(lc.shape)
    with pytest.raises(ValueError, match="multiple of 8|16-byte aligned"):
        kernel(*args, **kw)
    monkeypatch.setattr(es, "_check_vectors", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="rows_residual failed"):
        kernel(*args, **kw)
        torch.cuda.synchronize()


@pytest.mark.gpu
def test_row_kernel_first_computes_the_memory_row():
    """Without a memory row given, rows_first takes the mean of the raw
    utterance (the first layer's), and rolls it in where advance is set."""
    dev = _cuda()
    calls, M = _row_calls(ROW_SHAPES["vi"], dev)
    kernel, plain, args, kw, *_ = calls["first"]
    got = kernel(*args[:6], **kw)
    torch.cuda.synchronize()
    U = kw["U"]
    torch.testing.assert_close(got[4], args[0][:, :U].mean(1), rtol=1e-5,
                               atol=1e-6)
    assert torch.equal(got[5], plain(*args[:6], got[4], **kw)[5])


@pytest.mark.gpu
@pytest.mark.parametrize("name,quant,want", [
    ("vi", "none", "3b1285556ac07a17"), ("en", "none", "08d7d419dc924606"),
    ("vi", "int8", "b1f053aeb1741496"), ("vi", "int8_ffn", "80ef570bd39bb1f1")])
def test_emformer_stack_digest_is_unchanged(name, quant, want):
    """One full-width bf16 step of kernel A (512 slots, 20 layers, seed 0,
    chip_smoke.stack_digest) gives the same bits as the chain whose row
    kernels ran in four launches a layer, and in W8A8 as the chain whose
    quantiser read every product's rows back from memory (the digests
    they gave on an H100)."""
    import dataclasses
    import chip_smoke
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    dev = _cuda()
    cfg = (te.EmformerConfig(compute_dtype=torch.bfloat16) if name == "vi"
           else dataclasses.replace(RNNTConfig().emformer,
                                    compute_dtype=torch.bfloat16))
    digest, _ = chip_smoke.stack_digest(cfg, chip_smoke.B_SLOTS, 0, dev, name,
                                        quant=quant)
    assert digest[:16] == want


@pytest.mark.gpu
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
@pytest.mark.parametrize("dtype,quant", [(torch.bfloat16, "none"),
                                         (torch.float32, "none"),
                                         (torch.bfloat16, "int8"),
                                         (torch.bfloat16, "int8_ffn"),
                                         (torch.float32, "int8")],
                         ids=["bf16", "f32", "int8", "int8_ffn", "f32_int8"])
def test_a_step_launches_two_row_kernels_a_layer(geo, dtype, quant):
    """A step of L layers launches 2 L + 1 row kernels: rows_first once,
    rows_residual L times, rows_boundary L - 1 times, rows_last once (the
    library's counters), and the profile holds no other row kernel.  Its
    GEMM launches a layer: the q and kv products in one, then out, ffn1
    and ffn2 (bf16, or int8 where quantised; f32 runs neither); the row
    quantiser only for out and ffn2 (W8A8 q, kv and ffn1 rows are
    quantised in the row kernels)."""
    from torch.profiler import ProfilerActivity, profile
    dev = _cuda()
    cfg = te.EmformerConfig(**geo, compute_dtype=dtype, quant=quant)
    params = te.init_emformer_params(torch.Generator().manual_seed(0), cfg,
                                     dev)
    st = te.init_emformer_state(cfg, 4, dev)
    x = torch.randn((4, cfg.segment_length + cfg.right_context_length,
                     cfg.d_model), device=dev)
    kw = dict(U=cfg.segment_length, R=cfg.right_context_length,
              M=cfg.max_memory_size, Lc=cfg.left_context_length,
              H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=dtype, quant=quant)
    es.emformer_stack(params, x, st.mem, st.lc_k, st.lc_v, st.length, **kw)
    torch.cuda.synchronize()
    before = es.kernel_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        es.emformer_stack(params, x, st.mem, st.lc_k, st.lc_v, st.length,
                          **kw)
        torch.cuda.synchronize()
    counts = {k: n - before[k] for k, n in es.kernel_launch_counts().items()}
    L = cfg.num_layers
    names = es._kernel_quant_names(quant)
    int8 = {"none": 0, "int8": 4, "int8_ffn": 2}[quant]
    bf16 = 4 - int8 if dtype == torch.bfloat16 else 0
    assert counts == {"rows_first": 1, "rows_residual": L,
                      "rows_boundary": L - 1, "rows_last": 1,
                      "quantize_rows": L * len({"w_out", "ff_w2"} & set(names)),
                      "gemm_int8": L * int8, "gemm_bf16": L * bf16,
                      "attention": L}
    names = {e.key for e in prof.key_averages()}
    assert not [n for n in names
                if any(k in n for k in ("state_roll", "ln_in", "out_ln",
                                        "residual_ffn_ln"))]


# The attention core's persistent plan (csrc/emformer_attention_core.cuh):
# fewer slots than SMs, one and three (the offline API's small-B plan), and
# partial last waves of the persistent grid; a 64-wide head (the serving
# width, fixed at compile time) and 16-wide (the other kernels).
ATTN_BATCHES = [1, 2, 7, 131, 133, 512]
# geometry cases: (D, H, U, R, M, Lc): the VI shape at a narrow width, no
# memory (EN), K = 128 keys, 16-wide heads; and the serving widths (VI
# and EN at D = 512, H = 8: their own plans of heads a unit, groups and
# stages), run at a partial last wave and below the SMs
ATTN_GEOS = {"vi": (128, 2, 16, 4, 4, 32), "en": (128, 2, 4, 1, 0, 30),
             "k128": (128, 2, 16, 4, 4, 104), "dh16": (64, 4, 8, 2, 4, 16),
             "vi512": (512, 8, 16, 4, 4, 32), "en512": (512, 8, 4, 1, 0, 30)}
ATTN_CASES = ([(B, geo) for B in ATTN_BATCHES
               for geo in ("vi", "en", "k128", "dh16")]
              + [(B, geo) for B in (7, 133) for geo in ("vi512", "en512")])


def _churned_lengths(B, U, Lc, gen):
    """Lengths 0, 1, U, past Lc and random, and reset slots among the
    advancing ones: every fill-count case of the mask."""
    fixed = torch.tensor([0, 1, U, Lc + 3, 3 * U + 2], dtype=torch.int32)
    rand = torch.randint(0, 8 * U, (B,), generator=gen, dtype=torch.int32)
    length = torch.where(torch.arange(B) < len(fixed),
                         fixed[torch.arange(B) % len(fixed)], rand)
    reset = torch.rand(B, generator=gen) < 0.25
    advance = torch.rand(B, generator=gen) < 0.75
    return length, reset, advance


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,geo", ATTN_CASES)
def test_stack_attention_matches_plain_at_any_batch(B, geo, dtype, tol):
    """Kernel A (its attention on the persistent core: tensor cores in
    bf16, the FMA path in f32) against its plain version over two chained
    steps, at each batch and geometry; its launches counted, two a step."""
    dev = _cuda()
    D, H, U, R, M, Lc = ATTN_GEOS[geo]
    cfg = te.EmformerConfig(d_model=D, num_heads=H, ffn_dim=128,
                            num_layers=2, segment_length=U,
                            left_context_length=Lc, right_context_length=R,
                            max_memory_size=M, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(B)
    params = te.init_emformer_params(gen, cfg, dev)
    kw = dict(U=U, R=R, M=M, Lc=Lc, H=H, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=dtype)
    length, reset, advance = _churned_lengths(B, U, Lc, gen)
    state = [torch.randn((2, B, n, D), generator=gen).to(dev, dtype)
             for n in (M, Lc, Lc)]
    length, reset, advance = length.to(dev), reset.to(dev), advance.to(dev)
    for _ in range(2):
        x = torch.randn((B, U + R, D), generator=gen).to(dev)
        eff = torch.where(reset, torch.zeros_like(length), length)
        before = es.kernel_launch_counts()["attention"]
        got = es.emformer_stack(params, x, *state, eff, reset, advance, **kw)
        assert es.kernel_launch_counts()["attention"] == before + 2
        want = es.emformer_stack_plain(params, x, *state, eff, reset, advance,
                                       **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
        state = list(want[1:])
        length = torch.where(advance, eff + U, eff).to(torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,geo", ATTN_CASES)
def test_emformer_attention_kernel_matches_plain_at_any_batch(B, geo, dtype):
    """Kernel D at each batch and geometry (f32 or bf16 in, f32 out)
    against its plain version at 1e-4."""
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    dev = _cuda()
    D, H, U, R, M, Lc = ATTN_GEOS[geo]
    Q, K = R + U + (1 if M else 0), M + R + Lc + U
    gen = torch.Generator().manual_seed(B + 1)
    q, k, v = (torch.randn(s, generator=gen).to(dev, dtype)
               for s in ((B, Q, D), (B, K, D), (B, K, D)))
    length = _churned_lengths(B, U, Lc, gen)[0].to(dev)
    m_kv = torch.clamp(length, max=Lc)
    m_m = torch.clamp(length // U, max=M)
    kw = dict(num_heads=H, M=M, R=R, Lc=Lc, U=U, use_mem=M > 0)
    n0 = ek.LAUNCHES
    got = ek.emformer_attention(q, k, v, m_m, m_kv, **kw)
    assert ek.LAUNCHES == n0 + 1
    want = ek.emformer_attention_plain(q, k, v, m_m, m_kv, **kw)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,dtype,B,geo", [
    ("A", torch.bfloat16, 512, (512, 8, 16, 4, 4, 32)),
    ("A", torch.bfloat16, 512, (512, 8, 4, 1, 0, 30)),
    ("A", torch.float32, 1, (512, 8, 16, 4, 4, 32)),
    ("A", torch.float32, 133, (128, 2, 16, 4, 4, 104)),
    ("D", torch.float32, 512, (512, 8, 16, 4, 4, 32)),
    ("D", torch.bfloat16, 7, (64, 4, 8, 2, 4, 16))],
    ids=["vi_bf16", "en_bf16", "b1_f32", "k128_f32", "d_f32", "d_bf16"])
def test_attention_plan_is_the_librarys(kind, dtype, B, geo):
    """ops/emformer_attention.py::attention_plan (which the CPU tests
    check) is the plan the CUDA core computes on the host."""
    from asr_streaming_tpu_torch.ops import emformer_attention as ek
    _cuda()
    D, H, U, R, M, Lc = geo
    Q, K = R + U + (1 if M else 0), M + R + Lc + U
    lib = ek.kernel_attention_plan(kind, B=B, Q=Q, K=K, D=D, H=H, M=M, R=R,
                                   Lc=Lc, use_mem=M > 0, dtype=dtype)
    itemsize = 2 if dtype == torch.bfloat16 else 4
    want = (ek.stack_attention_plan(B, H, D, U, R, M, Lc, M > 0, itemsize)
            if kind == "A" else ek.plain_attention_plan(B, Q, K, D, H, itemsize))
    assert {k: lib[k] for k in want} == want
    assert lib["resident"] >= 1 and lib["registers"] <= 128
