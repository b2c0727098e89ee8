"""Kernel A's row kernels, split as the CUDA chain splits them.

``csrc/emformer_stack.cu`` runs a layer's row work in two launches
(``rows_residual`` after the out product, the FFN LN with the
left-context half of the state roll; ``rows_boundary`` after ffn2, this
layer's output LN of out + hin + h2 and the next layer's input LN with
the memory half of its roll), with
``rows_first`` before the first layer and ``rows_last`` after the last.
Here their plain versions (what the wrappers run on CPU tensors) are
chained in that order, the products and the attention by the existing
plain functions, and the chain is held against ``emformer_stack_plain``
(exact in f32 and bf16, every rolled state row equal) and against the
JAX package's ``fused_emformer_stack`` in interpret mode at
tests/test_pallas_emformer.py's tolerances (2e-5 in f32, 3e-2 in bf16).
In W8A8 mode the row functions hand back the q, kv and ffn1 products'
int8 rows and scales, as the kernels write them; the chain built from
those and the plain int8 product is held against the stack's plain
version exactly, and against the JAX package's quantised stack at the
bf16 tolerance (3e-2: an int8 value flips wherever the frameworks' f32
LN rows differ in the last bit at a rounding boundary;
tests/test_torch_w8a8.py).
Inputs come from a numpy seed; the geometries are ``ASRConfig.tiny``'s
Emformer, ``RNNTConfig.tiny``'s (no memory) and one with Lc < U (no
left-context row kept).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asr_streaming_tpu.models import asr as ja
from asr_streaming_tpu.models import rnnt as jr
from asr_streaming_tpu.ops.pallas_emformer import fused_emformer_stack
from asr_streaming_tpu_torch.models import emformer as te
from asr_streaming_tpu_torch.ops import emformer_stack as es
from tests.torch_train_common import one_torch_thread  # noqa: F401

_FIELDS = ("d_model", "num_heads", "ffn_dim", "num_layers", "segment_length",
           "left_context_length", "right_context_length", "max_memory_size")


def _geometry(jcfg):
    return {f: getattr(jcfg, f) for f in _FIELDS}


GEOMETRIES = {
    "asr_tiny": _geometry(ja.ASRConfig.tiny().encoder.emformer),
    "rnnt_tiny": _geometry(jr.RNNTConfig.tiny().emformer),
}
# Lc < U: no left-context row is kept, the newest Lc utterance rows are
GEOMETRIES["asr_tiny_lc4"] = dict(GEOMETRIES["asr_tiny"],
                                  left_context_length=4)
DTYPES = {"f32": (torch.float32, "float32", 2e-5),
          "bf16": (torch.bfloat16, "bfloat16", 3e-2)}
B = 6


def _masks(kind, rng):
    if kind == "all_reset":
        return np.ones(B, bool), rng.random(B) < 0.5
    if kind == "none_advance":
        return rng.random(B) < 0.5, np.zeros(B, bool)
    # every (reset, advance) pair, twice over the six slots
    return (np.array([1, 1, 0, 0, 1, 0], bool),
            np.array([1, 0, 1, 0, 0, 1], bool))


def _case(geo, dtype, masks, seed=0):
    cdt, _, _ = DTYPES[dtype]
    cfg = te.EmformerConfig(**geo, compute_dtype=cdt)
    params = te.init_emformer_params(torch.Generator().manual_seed(seed), cfg,
                                     "cpu")
    rng = np.random.default_rng(seed + 1)
    L, D = cfg.num_layers, cfg.d_model
    U, R = cfg.segment_length, cfg.right_context_length
    M, Lc = cfg.max_memory_size, cfg.left_context_length

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    arrays = {"x": normal(B, U + R, D), "mem": normal(L, B, M, D),
              "lc_k": normal(L, B, Lc, D), "lc_v": normal(L, B, Lc, D)}
    reset, advance = _masks(masks, rng)
    length = rng.integers(0, 5 * U, B).astype(np.int32)
    length[reset] = 0                       # reset-effective
    kw = dict(U=U, R=R, M=M, Lc=Lc, H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=cdt)
    return params, arrays, reset, advance, length, kw


def _torch_inputs(arrays, reset, advance, length, cdt):
    t = {k: torch.from_numpy(v) for k, v in arrays.items()}
    for k in ("mem", "lc_k", "lc_v"):
        t[k] = t[k].to(cdt)
    return (t["x"], t["mem"], t["lc_k"], t["lc_v"], torch.from_numpy(length),
            torch.from_numpy(reset), torch.from_numpy(advance))


def _chain(params, x, mem, lc_k, lc_v, length, reset, advance, *, U, R, M,
           Lc, H, use_mem, tanh_on_mem, neg_inf, activation, cdt,
           quant="none"):
    """One step of L layers in the CUDA chain's order, on the row kernels'
    plain versions: rows_first; per layer the q and kv products, the
    attention, the out product, rows_residual (with the left-context
    roll), ffn1, ffn2; rows_boundary between layers, rows_last after the
    last.  A W8A8 product takes the int8 rows its row function handed
    back (q, kv, ffn1) or quantises its rows (out, ffn2), then runs the
    plain int8 product.  Returns (y, new_mem, new_lc_k, new_lc_v) as the
    stack does."""
    L, Bs, D = params["w_q"].shape[0], x.shape[0], x.shape[2]
    T = U + R
    Q, NKV = T + int(use_mem), M + T
    plain = es.gemm_bf16_plain if cdt == torch.bfloat16 else \
        es.gemm_f32_plain
    names = es._kernel_quant_names(quant)
    qall = es.quantized_weights(params, names)

    def product(name, rows, q8, w, l, activation=None):
        bias = w[name.replace("w_", "b_").replace("_w", "_b")]
        if name not in names:
            return plain(rows.reshape(-1, rows.shape[-1]), w[name], bias,
                         activation)
        xq, s = q8[name] if name in q8 else es.quantize_rows(rows)
        y = es.qdot_rows(xq.reshape(-1, xq.shape[-1]), s.reshape(-1),
                         qall[name][0][l], qall[name][1][l]).to(cdt) \
            + bias.to(cdt)
        return es._act(activation)(y) if activation else y

    reset3 = reset.view(Bs, 1, 1)
    hin, q_in, kv_in, q8, memrow, mem0 = es.rows_first(
        x, mem[0], reset, advance, params["ln_in_scale"][0],
        params["ln_in_bias"][0], U=U, R=R, use_mem=use_mem, cdt=cdt,
        quant=quant)
    mems, lcks, lcvs = [mem0], [], []
    for l in range(L):
        w = {k: v[l] for k, v in params.items()}
        q = product("w_q", q_in, q8, w, l)
        kv = product("w_kv", kv_in, q8, w, l).reshape(Bs, NKV, 2 * D)
        lc0 = [torch.where(reset3, torch.zeros_like(t[l]), t[l]).to(cdt)
               for t in (lc_k, lc_v)]
        attn = es._attention_plain(q.reshape(Bs, Q, D), kv, *lc0, length,
                                   U=U, R=R, M=M, Lc=Lc, H=H,
                                   use_mem=use_mem, neg_inf=neg_inf, cdt=cdt)
        out = product("w_out", attn.reshape(Bs * Q, D), {}, w, l)
        out = out.reshape(Bs, Q, D)
        ff_in, q8, memrow, nk, nv = es.rows_residual(
            out, hin, kv, lc_k[l], lc_v[l], reset, advance,
            w["ff_ln_scale"], w["ff_ln_bias"], U=U, R=R, M=M, Lc=Lc,
            use_mem=use_mem, tanh_on_mem=tanh_on_mem, quant=quant)
        lcks.append(nk)
        lcvs.append(nv)
        h1 = product("ff_w1", ff_in, q8, w, l, activation)
        h2 = product("ff_w2", h1, {}, w, l).reshape(Bs, T, D)
        if l + 1 < L:
            hin, q_in, kv_in, q8, m = es.rows_boundary(
                out, hin, h2, mem[l + 1], memrow, reset, advance,
                w["ln_out_scale"], w["ln_out_bias"],
                params["ln_in_scale"][l + 1], params["ln_in_bias"][l + 1],
                U=U, R=R, use_mem=use_mem, quant=quant)
            mems.append(m)
        else:
            hin, y = es.rows_last(out, hin, h2, w["ln_out_scale"],
                                  w["ln_out_bias"], U=U, R=R)
    return y, torch.stack(mems), torch.stack(lcks), torch.stack(lcvs)


@pytest.mark.parametrize("masks", ["mix", "all_reset", "none_advance"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_row_chain_equals_stack_plain(geo, dtype, masks):
    params, arrays, reset, advance, length, kw = _case(GEOMETRIES[geo], dtype,
                                                       masks)
    args = _torch_inputs(arrays, reset, advance, length, kw["cdt"])
    got = _chain(params, *args, **kw)
    want = es.emformer_stack_plain(params, *args, **kw)
    for name, g, w in zip(("y", "mem", "lc_k", "lc_v"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("quant", ["int8", "int8_ffn"])
@pytest.mark.parametrize("masks", ["mix", "all_reset", "none_advance"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_w8a8_row_chain_equals_stack_plain(geo, dtype, masks, quant):
    """The row functions' int8 rows and scales (q, kv, ffn1) with the plain
    int8 product give the quantised stack's plain version bit for bit."""
    params, arrays, reset, advance, length, kw = _case(GEOMETRIES[geo], dtype,
                                                       masks, seed=11)
    args = _torch_inputs(arrays, reset, advance, length, kw["cdt"])
    got = _chain(params, *args, **kw, quant=quant)
    want = es.emformer_stack_plain(params, *args, **kw, quant=quant)
    for name, g, w in zip(("y", "mem", "lc_k", "lc_v"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(g, w), name


@pytest.mark.parametrize("kind", ["first", "residual", "boundary"])
def test_w8a8_rows_stand_in_for_the_compute_type_rows(kind):
    """In W8A8 a row function makes no compute-type rows for a quantised
    product (None) and hands back its int8 rows [B, rows, D] and scales
    [B, rows]: ``quantize_rows_plain`` of the rows it makes unquantised
    (q's and ffn1's f32 rows, from the same call in f32 on the widened
    inputs; kv's compute-type rows)."""
    params, arrays, reset, advance, length, kw = _case(
        GEOMETRIES["asr_tiny"], "bf16", "mix", seed=4)
    x, mem, lc_k, lc_v, _, reset, advance = _torch_inputs(
        arrays, reset, advance, length, torch.bfloat16)
    U, R, M, Lc = kw["U"], kw["R"], kw["M"], kw["Lc"]
    Bs, T, D = x.shape
    ln = (params["ln_in_scale"][0], params["ln_in_bias"][0])
    g = torch.Generator().manual_seed(4)
    out = torch.randn((Bs, T + 1, D), generator=g).to(torch.bfloat16)
    h2 = torch.randn((Bs, T, D), generator=g).to(torch.bfloat16)
    kv = torch.randn((Bs, M + T, 2 * D), generator=g).to(torch.bfloat16)
    hin, memrow = torch.randn((Bs, T, D), generator=g), \
        torch.randn((Bs, D), generator=g)

    def call(quant, wide=False):
        f = (lambda t: t.float()) if wide else (lambda t: t)
        if kind == "first":
            return es.rows_first(x, f(mem[0]), reset, advance, *ln, U=U, R=R,
                                 use_mem=True, quant=quant,
                                 cdt=torch.float32 if wide else torch.bfloat16)
        if kind == "residual":
            return es.rows_residual(f(out), hin, f(kv), f(lc_k[0]),
                                    f(lc_v[0]), reset, advance, *ln, U=U,
                                    R=R, M=M, Lc=Lc, use_mem=True,
                                    tanh_on_mem=True, quant=quant)
        return es.rows_boundary(f(out), hin, f(h2), f(mem[0]), memrow, reset,
                                advance, *ln, *ln, U=U, R=R, use_mem=True,
                                quant=quant)

    got, own, wide = call("int8"), call("none"), call("none", wide=True)
    slot, rows = ((1, {"ff_w1": (0, T)}) if kind == "residual" else
                  (3, {"w_q": (1, T + 1), "w_kv": (2, M + T)}))
    assert set(got[slot]) == set(rows)
    for name, (i, n) in rows.items():
        assert got[i] is None, name
        xq, s = got[slot][name]
        assert xq.dtype == torch.int8 and xq.shape == (Bs, n, D), name
        assert s.dtype == torch.float32 and s.shape == (Bs, n), name
        want = es.quantize_rows_plain((own if name == "w_kv" else wide)[i])
        assert torch.equal(xq, want[0]) and torch.equal(s, want[1]), name


@pytest.mark.parametrize("quant", ["int8", "int8_ffn"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_w8a8_row_chain_matches_jax_stack_interpret(geo, dtype, quant):
    """The W8A8 chain against the JAX package's quantised stack in
    interpret mode, at the bf16 tolerance (see the module doc)."""
    params, arrays, reset, advance, length, kw = _case(GEOMETRIES[geo], dtype,
                                                       "mix", seed=13)
    cdt, cdt_name, _ = DTYPES[dtype]
    got = _chain(params, *_torch_inputs(arrays, reset, advance, length, cdt),
                 **kw, quant=quant)
    jkw = {k: v for k, v in kw.items() if k != "cdt"}
    jdt = jnp.dtype(cdt_name)
    want = fused_emformer_stack(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        jnp.asarray(arrays["x"]),
        *(jnp.asarray(arrays[k]).astype(jdt) for k in ("mem", "lc_k",
                                                       "lc_v")),
        jnp.asarray(length), jnp.asarray(reset), jnp.asarray(advance),
        cdt_name=cdt_name, tile=2, interpret=True, quant=quant, **jkw)
    for name, g, w in zip(("y", "mem", "lc_k", "lc_v"), got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=3e-2,
                                   atol=3e-2, err_msg=name)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_row_chain_matches_jax_stack_interpret(geo, dtype):
    params, arrays, reset, advance, length, kw = _case(GEOMETRIES[geo], dtype,
                                                       "mix", seed=3)
    cdt, cdt_name, tol = DTYPES[dtype]
    got = _chain(params, *_torch_inputs(arrays, reset, advance, length, cdt),
                 **kw)
    jkw = {k: v for k, v in kw.items() if k != "cdt"}
    jdt = jnp.dtype(cdt_name)
    want = fused_emformer_stack(
        {k: jnp.asarray(v.numpy()) for k, v in params.items()},
        jnp.asarray(arrays["x"]),
        *(jnp.asarray(arrays[k]).astype(jdt) for k in ("mem", "lc_k",
                                                       "lc_v")),
        jnp.asarray(length), jnp.asarray(reset), jnp.asarray(advance),
        cdt_name=cdt_name, tile=2, interpret=True, **jkw)
    for name, g, w in zip(("y", "mem", "lc_k", "lc_v"), got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g.float().numpy(), w, rtol=tol, atol=tol,
                                   err_msg=name)


@pytest.mark.parametrize("geo", list(GEOMETRIES))
def test_rolled_rows_are_the_kept_and_new_rows(geo):
    """The roll's rows, each from where the kernels take it: kept left
    context from the layer's input, new rows from its kv product, the
    memory shifted up with the layer's input memory row last, zeros where
    reset, the input (after reset) where a slot does not advance."""
    params, arrays, reset, advance, length, kw = _case(GEOMETRIES[geo], "f32",
                                                       "mix", seed=5)
    x, mem, lc_k, lc_v, length, reset_t, advance_t = _torch_inputs(
        arrays, reset, advance, length, torch.float32)
    U, R, M, Lc = kw["U"], kw["R"], kw["M"], kw["Lc"]
    D = x.shape[2]
    kv = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (B, M + U + R, 2 * D)).astype(np.float32))
    out = torch.zeros((B, U + R + int(kw["use_mem"]), D))
    hin = torch.zeros((B, U + R, D))
    ones = torch.ones(D)
    *_, nk, nv = es.rows_residual(out, hin, kv, lc_k[0], lc_v[0], reset_t,
                                  advance_t, ones, ones, U=U, R=R, M=M, Lc=Lc,
                                  use_mem=kw["use_mem"], tanh_on_mem=True)
    keep = max(0, Lc - U)
    for b in range(B):
        for new, lc, part in ((nk, lc_k, kv[b, :, :D]),
                              (nv, lc_v, kv[b, :, D:])):
            old = torch.zeros_like(lc[0, b]) if reset[b] else lc[0, b]
            want = torch.cat([old[Lc - keep:], part[M + R:][U - (Lc - keep):]]
                             ) if advance[b] else old
            assert torch.equal(new[b], want)
    if not kw["use_mem"]:
        return
    memrow = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, D)).astype(np.float32))
    *_, mem_out = es.rows_first(x, mem[0], reset_t, advance_t, ones, ones,
                                memrow, U=U, R=R, use_mem=True,
                                cdt=torch.float32)
    for b in range(B):
        old = torch.zeros_like(mem[0, b]) if reset[b] else mem[0, b]
        want = torch.cat([old[1:], memrow[b:b + 1]]) if advance[b] else old
        assert torch.equal(mem_out[b], want)


def test_layer_zero_memory_row_is_the_raw_utterance_mean():
    geo = GEOMETRIES["asr_tiny"]
    params, arrays, reset, advance, length, kw = _case(geo, "f32", "mix")
    x, mem, *_ = _torch_inputs(arrays, reset, advance, length, torch.float32)
    U = kw["U"]
    got = es.rows_first(x, mem[0], torch.from_numpy(reset),
                        torch.from_numpy(advance), params["ln_in_scale"][0],
                        params["ln_in_bias"][0], U=U, R=kw["R"],
                        use_mem=True, cdt=torch.float32)
    assert torch.equal(got[4], x[:, :U].mean(1))
    hin = got[0]
    assert torch.equal(hin, torch.cat([x[:, U:], x[:, :U]], 1))


def test_stack_refuses_memory_without_use_mem():
    """The chain's memory rows run exactly when M > 0 (use_mem)."""
    cfg = te.EmformerConfig(**GEOMETRIES["asr_tiny"])
    with pytest.raises(ValueError, match="use_mem"):
        es.run_chain("asr_emformer_stack", {"ln_in_scale": torch.zeros(
            cfg.num_layers, cfg.d_model), "ff_b1": torch.zeros(1, 96)}, {},
            torch.zeros(2, 20, cfg.d_model), None, None, None,
            torch.zeros(cfg.num_layers, 2, 4, cfg.d_model),
            torch.zeros(cfg.num_layers, 2, 32, cfg.d_model),
            torch.zeros(cfg.num_layers, 2, 32, cfg.d_model), None, U=16, R=4,
            M=4, Lc=32, H=4, use_mem=False, tanh_on_mem=True, neg_inf=-1e8,
            activation="gelu", cdt=torch.float32)


def _offset_view(shape, dtype, elements):
    """A contiguous tensor of ``shape`` whose data starts ``elements``
    values into a fresh allocation."""
    n = int(np.prod(shape))
    return torch.zeros(n + elements, dtype=dtype)[elements:].view(shape)


@pytest.mark.parametrize("dtype,D,offset,match", [
    (torch.bfloat16, 64, 0, None),
    (torch.float32, 36, 0, None),
    (torch.bfloat16, 36, 0, "multiple of 8"),
    (torch.float32, 34, 0, "multiple of 4"),
    (torch.bfloat16, 64, 1, "16-byte aligned"),
    (torch.float32, 64, 2, "16-byte aligned"),
])
def test_row_kernels_take_whole_16_byte_vectors(dtype, D, offset, match):
    """The row kernels copy the roll's rows in 16-byte vectors only: D must
    be a whole number of them and each tensor 16-byte aligned, else the
    launch is refused before it reaches the card."""
    t = _offset_view((2, 3, D), dtype, offset)
    if match is None:
        es._check_vectors("rows_residual", dtype, D, lck_in=t)
    else:
        with pytest.raises(ValueError, match=match):
            es._check_vectors("rows_residual", dtype, D, lck_in=t)


def test_stack_refuses_a_misaligned_state():
    """The chain rolls the caller's state in place of a copy, so a state
    view that is not 16-byte aligned is refused."""
    cfg = te.EmformerConfig(**GEOMETRIES["asr_tiny"])
    L, D = cfg.num_layers, cfg.d_model
    with pytest.raises(ValueError, match="lc_k is not 16-byte aligned"):
        es.run_chain("asr_emformer_stack", {"ln_in_scale": torch.zeros(
            L, D), "ff_b1": torch.zeros(1, 96)}, {},
            torch.zeros(2, 20, D), None, None, None,
            torch.zeros(L, 2, 4, D),
            _offset_view((L, 2, 32, D), torch.float32, 1),
            torch.zeros(L, 2, 32, D), None, U=16, R=4, M=4, Lc=32, H=4,
            use_mem=True, tanh_on_mem=True, neg_inf=-1e8,
            activation="gelu", cdt=torch.float32)
