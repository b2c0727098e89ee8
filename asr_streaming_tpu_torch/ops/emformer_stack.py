"""All-layer streaming Emformer step: CUDA kernel wrapper + plain version.

Counterpart of asr_streaming_tpu/ops/pallas_emformer.py::fused_emformer_stack,
with its W8A8 mode and helpers (``_quantize_weight``, ``_qdot``,
``_kernel_quant_names``).  ``emformer_stack`` takes the JAX layouts:
stacked params ``[L, ...]`` (weights ``[in, out]``), x ``[B, U+R, D]``
(utterance then right context), state mem ``[L,B,M,D]`` and lc_k/lc_v
``[L,B,Lc,D]`` in the compute type, the RESET-EFFECTIVE length ``[B]`` and
optional reset/advance ``[B]`` masks.  Returns (y ``[B,U,D]`` f32,
new_mem, new_lc_k, new_lc_v).

``quant``: ``"none"``; ``"int8"`` runs all five projection/FFN products
W8A8 (per-output-channel int8 weights quantised from the f32 params,
per-row dynamic int8 activations, exact int32 products, f32 dequant);
``"int8_ffn"`` only the two FFN products.

In f32 each product runs as ``gemm_f32_config`` says: up to 128 rows (the
offline API's 1-3 slots) on the split-K kernel, more on the tiled one;
``gemm_f32`` runs one product alone.

On a CUDA tensor it launches ``csrc/emformer_stack.cu``; on a CPU tensor
it runs ``emformer_stack_plain``, which follows the Pallas kernel's
``_layer_math`` line by line (same bf16 rounding points).  Nothing else.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch.ops import _cuda
from asr_streaming_tpu_torch.ops.emformer_attention import check_geometry

# launches of the CUDA kernel (one per call that reaches the card), in
# bf16/f32 mode and in W8A8 mode
LAUNCHES = 0
LAUNCHES_INT8 = 0

_MAT = ("w_q", "w_kv", "w_out", "ff_w1", "ff_w2")
_BIAS = ("b_q", "b_kv", "b_out", "ff_b1", "ff_b2")
_LN = ("ln_in_scale", "ln_in_bias", "ff_ln_scale", "ff_ln_bias",
       "ln_out_scale", "ln_out_bias")
_ACTS = {"relu": 1, "gelu": 2, "silu": 3}
# the kernel's W8A8 bit of each product (csrc/emformer_stack.cu QuantBits)
_QBITS = {"w_q": 1, "w_kv": 2, "w_out": 4, "ff_w1": 8, "ff_w2": 16}


# ------------------------------------------------------------------ W8A8

def _kernel_quant_names(quant) -> tuple:
    """The products a quant spec runs W8A8 (pallas_emformer.py:65-73):
    False/"none" -> (); True/"int8" -> all five; "int8_ffn" -> the two
    FFN products."""
    if quant in (True, "int8"):
        return _MAT
    if quant == "int8_ffn":
        return ("ff_w1", "ff_w2")
    return ()


def _quantize_weight(w: torch.Tensor, axis: int = -2):
    """Per-output-channel symmetric int8, w ~= w8 * scale; ``axis`` is the
    contraction axis.  As pallas_emformer.py::_quantize_weight: the scale
    is amax / 127 by a true division (a tensor divisor: PyTorch turns a
    division by a Python scalar into a product with its reciprocal on the
    card), and w / scale rounds half to even."""
    w = w.to(torch.float32)
    amax = torch.clamp(w.abs().amax(axis, keepdim=True), min=1e-8)
    scale = amax / torch.full_like(amax, 127.0)
    return torch.round(w / scale).to(torch.int8), scale


def _int_product(xq: torch.Tensor, w8: torch.Tensor) -> torch.Tensor:
    """xq [rows, K] int8 . w8 [K, N] int8, exact, as f32.  The sums reach
    127^2 * K (3.3e7 at K = 2048, past f32's 2^24), so they are taken in
    int64 on the CPU and in float64 on the card (exact below 2^53)."""
    if xq.device.type == "cpu":
        acc = torch.matmul(xq.to(torch.int64), w8.to(torch.int64))
    else:
        acc = torch.matmul(xq.to(torch.float64), w8.to(torch.float64))
    return acc.to(torch.float32)


def quantize_rows_plain(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """_qdot's per-row dynamic symmetric activation quant
    (pallas_emformer.py:58-60) of x [..., K], read as f32: (xq int8
    [..., K], s f32 [...]) with s = max(amax, 1e-8) * (1/127) and
    xq = round(x * (1/s)), the reciprocal taken and then multiplied."""
    x = x.to(torch.float32)
    amax = x.abs().amax(-1, keepdim=True)
    s = torch.clamp(amax, min=1e-8) * (1.0 / 127.0)
    xq = torch.round(x * torch.reciprocal(s)).to(torch.int8)
    return xq, s.squeeze(-1)


def qdot_rows(xq: torch.Tensor, s: torch.Tensor, w8: torch.Tensor,
              wscale: torch.Tensor) -> torch.Tensor:
    """The rest of _qdot on rows quantised already: xq [rows, K] int8 with
    scales s [rows] . w8 [K, N] int8 (exact), dequantised with wscale
    [1, N] -> [rows, N] f32."""
    return _int_product(xq, w8) * s.unsqueeze(-1) * wscale


def _qdot(x2d: torch.Tensor, w8: torch.Tensor, wscale: torch.Tensor
          ) -> torch.Tensor:
    """W8A8 product (pallas_emformer.py::_qdot): per-row dynamic symmetric
    activation quant, an exact int8 product, f32 dequant.  x2d [rows, K]
    f32, w8 [K, N] int8, wscale [1, N] f32 -> [rows, N] f32."""
    return qdot_rows(*quantize_rows_plain(x2d), w8, wscale)


# values derived from weight tensors, by (id of the tensor, tag):
# {key: (weakref to the tensor, its version, value)}; an entry goes with
# its tensor
_CACHE: dict = {}


def _cached(t: torch.Tensor, tag, make):
    """``make(t)``, cached per tensor and tag: made once per params object,
    dropped with the tensor, and made again if it is changed in place."""
    key = (id(t), tag)
    hit = _CACHE.get(key)
    if hit is None or hit[0]() is not t or hit[1] != t._version:
        ref = weakref.ref(t, lambda _, key=key: _CACHE.pop(key, None))
        hit = (ref, t._version, make(t))
        _CACHE[key] = hit
    return hit[2]


def _quantized(w: torch.Tensor):
    w8, scale = _quantize_weight(w, axis=-2)
    w8t = w8.transpose(-1, -2).contiguous() if w.device.type == "cuda" else None
    return w8, scale, w8t


def quantized_weights(params: dict, names) -> dict:
    """{name: (w8 [..., K, N] int8, scale [..., 1, N] f32, w8t)} for the
    named f32 weights of ``params`` (stacked or one layer's).  Quantisation
    is deterministic, so the result is cached per weight tensor
    (``_cached``); ``w8t`` is the contiguous [..., N, K] copy the CUDA
    kernel reads (None on the CPU)."""
    return {name: _cached(params[name], "int8", _quantized) for name in names}


# ----------------------------------------------------------- plain version

def _ln(x, scale, bias, eps=1e-5):
    x = x.to(torch.float32)
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _mm(x2d, w, cdt):
    """Product in f32 of compute-type operands, rounded to the compute
    type once (jnp.dot(..., preferred_element_type=f32).astype(cdt))."""
    return torch.matmul(x2d.to(cdt).float(), w.to(cdt).float()).to(cdt)


def _act(name):
    return {"relu": F.relu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "silu": F.silu}[name]


def _attention_plain(q, kv, lc_k, lc_v, length, *, U, R, M, Lc, H,
                     use_mem, neg_inf, cdt):
    """The layer's masked attention (pallas_emformer.py::_layer_math):
    q [B, Q, D] and kv [B, M+R+U, 2D] from the products, lc_k / lc_v
    [B, Lc, D] the left context (zero where reset) -> [B, Q, D] cdt."""
    B, Q, D = q.shape
    Dh = D // H
    K = M + R + Lc + U
    k_part, v_part = kv[:, :, :D], kv[:, :, D:]
    full_k = torch.cat([k_part[:, :M + R], lc_k, k_part[:, M + R:]], 1)
    full_v = torch.cat([v_part[:, :M + R], lc_v, v_part[:, M + R:]], 1)

    # key validity from the per-slot fill counters
    length = length.view(B, 1).to(torch.int64)
    col = torch.arange(K, device=q.device).view(1, K)
    m_kv = torch.clamp(length, max=Lc)
    lc_start = M + R
    valid = ~((col >= lc_start) & (col < lc_start + (Lc - m_kv)))
    if use_mem:
        m_m = torch.clamp(torch.div(length, max(U, 1), rounding_mode="floor"),
                          max=M)
        valid = valid & ~((col < M) & (col < (M - m_m)))
    mask = valid.view(B, 1, K).expand(B, Q, K).clone()
    if use_mem:
        mask[:, Q - 1, :M] = False                 # summary row: no memory

    scaling = 1.0 / math.sqrt(Dh)
    qh = (q * scaling).view(B, Q, H, Dh).transpose(1, 2)          # cdt
    kh = full_k.view(B, K, H, Dh).transpose(1, 2)
    vh = full_v.view(B, K, H, Dh).transpose(1, 2)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(neg_inf, dtype=torch.float32,
                                      device=logits.device))
    probs = torch.softmax(logits, -1).to(cdt)
    attn = torch.matmul(probs.float(), vh.float())                 # f32
    return attn.transpose(1, 2).reshape(B, Q, D).to(cdt)


def _layer_plain(utt, rc, mem_row, mem_state_in, lc_k_in, lc_v_in, length,
                 reset, advance, w, *, U, R, M, Lc, H, use_mem, tanh_on_mem,
                 neg_inf, activation, cdt, qw=None):
    """One layer: pallas_emformer.py::_layer_math in PyTorch.  ``qw``:
    {name: (w8, scale, ...)} of this layer's W8A8 products."""
    B, _, D = utt.shape
    qw = qw or {}

    def proj(x2d, name):
        if name in qw:
            return _qdot(x2d.to(torch.float32), qw[name][0],
                         qw[name][1]).to(cdt)
        return _mm(x2d, w[name], cdt)

    Q = R + U + (1 if use_mem else 0)
    reset3 = reset.view(B, 1, 1)
    adv3 = advance.view(B, 1, 1)

    ln_rc = _ln(rc, w["ln_in_scale"], w["ln_in_bias"])
    ln_utt = _ln(utt, w["ln_in_scale"], w["ln_in_bias"])
    if use_mem:
        summary = ln_utt.mean(1, keepdim=True)
        q_in = torch.cat([ln_rc, ln_utt, summary], 1)
    else:
        q_in = torch.cat([ln_rc, ln_utt], 1)

    q = (proj(q_in.reshape(B * Q, D), "w_q")
         + w["b_q"].to(cdt)).reshape(B, Q, D)

    mem_state = torch.where(reset3, torch.zeros_like(mem_state_in),
                            mem_state_in)
    parts = ([mem_state.to(cdt)] if use_mem else []) + [ln_rc.to(cdt),
                                                        ln_utt.to(cdt)]
    kv_in = torch.cat(parts, 1)
    n_kv = kv_in.shape[1]
    kv = (proj(kv_in.reshape(B * n_kv, D), "w_kv")
          + w["b_kv"].to(cdt)).reshape(B, n_kv, 2 * D)
    k_part, v_part = kv[:, :, :D], kv[:, :, D:]
    next_k, next_v = k_part[:, M + R:], v_part[:, M + R:]

    lc_k = torch.where(reset3, torch.zeros_like(lc_k_in), lc_k_in).to(cdt)
    lc_v = torch.where(reset3, torch.zeros_like(lc_v_in), lc_v_in).to(cdt)
    attn = _attention_plain(q, kv, lc_k, lc_v, length, U=U, R=R, M=M, Lc=Lc,
                            H=H, use_mem=use_mem, neg_inf=neg_inf, cdt=cdt)

    out = (proj(attn.reshape(B * Q, D), "w_out")
           + w["b_out"].to(cdt)).reshape(B, Q, D)

    rc_utt_out = out[:, :R + U].float()
    new_mem_row = None
    if use_mem:
        mem_out = out[:, R + U:].float()
        new_mem_row = (torch.tanh(mem_out) if tanh_on_mem
                       else torch.clamp(mem_out, -10.0, 10.0))

    residual = rc_utt_out + torch.cat([rc, utt], 1)
    ff = _ln(residual, w["ff_ln_scale"], w["ff_ln_bias"])
    T = R + U
    h1 = _act(activation)(proj(ff.reshape(B * T, D), "ff_w1")
                          + w["ff_b1"].to(cdt))
    h2 = (proj(h1, "ff_w2") + w["ff_b2"].to(cdt)).reshape(B, T, D)
    result = _ln(residual + h2.float(), w["ln_out_scale"], w["ln_out_bias"])
    new_rc, new_utt = result[:, :R], result[:, R:]

    # state roll (newest at the end), committed only where advance
    state_dtype = lc_k_in.dtype
    if use_mem:
        rolled = torch.cat([mem_state[:, 1:], mem_row.to(mem_state.dtype)], 1)
        new_mem_state = torch.where(adv3, rolled, mem_state)
    else:
        new_mem_state = mem_state
    keep = max(0, Lc - U)
    new_lc_k = torch.cat([lc_k[:, Lc - keep:], next_k[:, U - (Lc - keep):]],
                         1).to(state_dtype)
    new_lc_v = torch.cat([lc_v[:, Lc - keep:], next_v[:, U - (Lc - keep):]],
                         1).to(state_dtype)
    new_lc_k = torch.where(adv3, new_lc_k, lc_k.to(state_dtype))
    new_lc_v = torch.where(adv3, new_lc_v, lc_v.to(state_dtype))
    return (new_utt, new_rc, new_mem_row, new_mem_state.to(state_dtype),
            new_lc_k, new_lc_v)


def emformer_stack_plain(params, x, mem, lc_k, lc_v, length, reset, advance,
                         *, U, R, M, Lc, H, use_mem, tanh_on_mem, neg_inf,
                         activation, cdt, quant="none"):
    """The plain PyTorch version of the kernel (any device)."""
    L = params["w_q"].shape[0]
    qall = quantized_weights(params, _kernel_quant_names(quant))
    xf = x.to(torch.float32)
    utt, rc = xf[:, :U], xf[:, U:U + R]
    mem_row = utt.mean(1, keepdim=True) if use_mem else None
    mems, lcks, lcvs = [], [], []
    for l in range(L):
        w = {k: v[l] for k, v in params.items()}
        utt, rc, new_row, nm, nk, nv = _layer_plain(
            utt, rc, mem_row, mem[l], lc_k[l], lc_v[l], length, reset,
            advance, w, U=U, R=R, M=M, Lc=Lc, H=H, use_mem=use_mem,
            tanh_on_mem=tanh_on_mem, neg_inf=neg_inf, activation=activation,
            cdt=cdt, qw={n: (t[0][l], t[1][l]) for n, t in qall.items()})
        mem_row = new_row
        mems.append(nm)
        lcks.append(nk)
        lcvs.append(nv)
    return utt, torch.stack(mems), torch.stack(lcks), torch.stack(lcvs)


# ----------------------------------------------------------- CUDA wrapper

class _Args(ctypes.Structure):
    """Mirrors ``EmformerStackArgs`` in csrc/emformer_stack.cu."""
    _fields_ = ([("struct_size", ctypes.c_int64), ("dtype", ctypes.c_int32)]
                + [(n, ctypes.c_int32) for n in (
                    "B", "L", "D", "H", "F", "U", "R", "M", "Lc",
                    "use_mem", "tanh_on_mem", "activation", "quant",
                    "init_memrow")]
                + [("neg_inf", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in (
                    "x", "length", "reset", "advance",
                    "mem_in", "lck_in", "lcv_in",
                    "wq", "bq", "wkv", "bkv", "wout", "bout",
                    "lnin_s", "lnin_b", "ffln_s", "ffln_b",
                    "w1", "b1", "w2", "b2", "lnout_s", "lnout_b",
                    "wq8", "wq_s", "wkv8", "wkv_s", "wout8", "wout_s",
                    "w18", "w1_s", "w28", "w2_s",
                    "y", "mem_out", "lck_out", "lcv_out",
                    "q_in", "kv_in", "q", "kv", "attn", "out", "ff_in",
                    "h1", "h2", "hin", "memrow",
                    "aq", "a_scale", "q8", "q8_s", "kv8", "kv8_s", "ff8",
                    "ff8_s")]
                + [("f32_kslice", ctypes.c_int32 * 5)]
                + [(n, ctypes.c_void_p) for n in (
                    "f32_ws", "f32_tiles", "stream")])


# the int8 weight / scale fields of each product
_QFIELDS = {"w_q": ("wq8", "wq_s"), "w_kv": ("wkv8", "wkv_s"),
            "w_out": ("wout8", "wout_s"), "ff_w1": ("w18", "w1_s"),
            "ff_w2": ("w28", "w2_s")}
# the products whose int8 rows the row kernels write (in place of the
# compute-type rows): {name: (int8 rows, scales, compute-type rows)}
_ROW_QUANT = {"w_q": ("q8", "q8_s", "q_in"), "w_kv": ("kv8", "kv8_s", "kv_in"),
              "ff_w1": ("ff8", "ff8_s", "ff_in")}
_WFIELDS = {"w_q": "wq", "b_q": "bq", "w_kv": "wkv", "b_kv": "bkv",
            "w_out": "wout", "b_out": "bout", "ln_in_scale": "lnin_s",
            "ln_in_bias": "lnin_b", "ff_ln_scale": "ffln_s",
            "ff_ln_bias": "ffln_b", "ff_w1": "w1", "ff_b1": "b1",
            "ff_w2": "w2", "ff_b2": "b2", "ln_out_scale": "lnout_s",
            "ln_out_bias": "lnout_b"}


def _kernel_tensor(t: torch.Tensor, dtype: torch.dtype,
                   transpose: bool = False) -> torch.Tensor:
    """``t`` in ``dtype``, contiguous, its last two axes swapped with
    ``transpose``.  A copy is cached per source tensor (``_cached``), so a
    weight is cast and transposed once per params object, not per step; a
    tensor that needs no copy is returned as it is."""
    if t.dtype == dtype and not transpose and t.is_contiguous():
        return t

    def make(t):
        out = t.to(dtype)
        return (out.transpose(-1, -2) if transpose else out).contiguous()
    return _cached(t, (dtype, transpose), make)


def kernel_weights(params: dict, cdt: torch.dtype, skip=()) -> dict:
    """Weights as the kernel reads them: products and biases in the
    compute type, the bf16 products transposed to ``[..., out, in]`` (the
    K-major operand of the wgmma GEMM), LN vectors in f32, contiguous;
    cached per source tensor (``_kernel_tensor``).  The products in
    ``skip`` run W8A8 and are left out."""
    tr = cdt == torch.bfloat16
    w = {n: _kernel_tensor(params[n], cdt, tr) for n in _MAT
         if n not in skip}
    w.update({n: _kernel_tensor(params[n], cdt) for n in _BIAS})
    w.update({n: _kernel_tensor(params[n], torch.float32) for n in _LN})
    return w


def _ptr(t):
    return t.data_ptr() if t is not None and t.numel() else None


def _check_vectors(what: str, cdt: torch.dtype, D: int, **tensors) -> None:
    """Raise unless the row kernels' 16-byte vectors fit: D a whole number
    of them (8 bf16 or 4 f32 values) and each named tensor's data 16-byte
    aligned (a fresh allocation is; a view at an odd offset is not)."""
    vec = 16 // torch.empty((), dtype=cdt).element_size()
    if D % vec:
        raise ValueError(f"{what}: D={D} is not a multiple of {vec} "
                         f"({cdt} values in 16 bytes)")
    for name, t in tensors.items():
        if t is not None and t.numel() and t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} is not 16-byte aligned")


def run_chain(entry: str, w: dict, qw: dict, x, length, reset, advance, mem,
              lc_k, lc_v, memrow, *, U, R, M, Lc, H, use_mem, tanh_on_mem,
              neg_inf, activation, cdt, init_memrow=0):
    """Launch the layer chain of csrc/emformer_stack.cu through ``entry``
    (``asr_emformer_stack`` or ``asr_emformer_layer``), on the card.

    w: kernel weights (``kernel_weights``, stacked ``[L, ...]``); qw:
    {name: (w8, scale, w8t)} of the W8A8 products; x [B, U+R, D]
    (utterance then right context); mem/lc_k/lc_v [L, B, rows, D] in the
    compute type; memrow [B, D] f32, read and written (the memory row).
    Returns (y [B,U,D] f32, new_mem, new_lc_k, new_lc_v, hin [B,R+U,D]
    f32: the last layer's output rows [rc; utt])."""
    dev = x.device
    L, D = w["ln_in_scale"].shape
    B = x.shape[0]
    Fd = w["ff_b1"].shape[-1]
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"emformer kernel: unsupported dtype {cdt}")
    if activation not in _ACTS:
        raise ValueError(f"emformer kernel: activation {activation}")
    if D > 1024 or D % H:
        raise ValueError(f"emformer kernel: D={D}, H={H}")
    if cdt == torch.bfloat16 and (D % 8 or Fd % 8):
        raise ValueError(f"emformer kernel: bf16 needs D and F multiples of "
                         f"8 (D={D}, F={Fd})")
    if qw and (D % 16 or Fd % 16):
        raise ValueError(f"emformer kernel: W8A8 needs D and F multiples of "
                         f"16 (D={D}, F={Fd})")
    if tuple(x.shape) != (B, U + R, D):
        raise ValueError(f"x shape {tuple(x.shape)} != {(B, U + R, D)}")
    for name, t, rows in (("mem", mem, M), ("lc_k", lc_k, Lc),
                          ("lc_v", lc_v, Lc)):
        if tuple(t.shape) != (L, B, rows, D) or t.dtype != cdt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{(L, B, rows, D)} {cdt}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    for name, t in w.items():
        # a cached kernel copy lives on its source weight's device
        if t.device != dev:
            raise ValueError(f"weight {name} is on {t.device}, x on {dev}")
    if use_mem != (M > 0):
        raise ValueError(f"use_mem={use_mem} needs M > 0, and M={M} needs "
                         f"use_mem")
    check_geometry(R + U + int(use_mem), M + R + Lc + U, D // H, cdt,
                   mma=cdt == torch.bfloat16, what="emformer kernel")

    x = x.to(torch.float32).contiguous()
    mem, lc_k, lc_v = mem.contiguous(), lc_k.contiguous(), lc_v.contiguous()
    _check_vectors("emformer kernel", cdt, D, mem=mem, lc_k=lc_k, lc_v=lc_v)
    length = length.to(device=dev, dtype=torch.int32).contiguous()
    reset = reset.to(device=dev, dtype=torch.uint8).contiguous()
    advance = advance.to(device=dev, dtype=torch.uint8).contiguous()

    T = U + R
    Q = T + (1 if use_mem else 0)
    NKV = M + T
    y = torch.empty((B, U, D), dtype=torch.float32, device=dev)
    new_mem = torch.empty_like(mem)
    new_lck = torch.empty_like(lc_k)
    new_lcv = torch.empty_like(lc_v)

    def scratch(*shape, dtype=cdt):
        return torch.empty(shape, dtype=dtype, device=dev)

    s = {"q": scratch(B, Q, D), "kv": scratch(B, NKV, 2 * D),
         "attn": scratch(B, Q, D), "out": scratch(B, Q, D),
         "h1": scratch(B, T, Fd), "h2": scratch(B, T, D),
         "hin": scratch(B, T, D, dtype=torch.float32)}
    # a product's input rows: in the compute type, or in W8A8 int8 rows
    # and their scales, which the row kernels write (q, kv, ffn1) or the
    # quantiser, into one buffer that out and ffn2 take in turn
    q = {}
    for name, rows in (("w_q", Q), ("w_kv", NKV), ("ff_w1", T)):
        f8, fs, fin = _ROW_QUANT[name]
        if name in qw:
            q[f8] = scratch(B * rows * D, dtype=torch.int8)
            q[fs] = scratch(B * rows, dtype=torch.float32)
        else:
            s[fin] = scratch(B, rows, D)
    if qw:
        rows = B * max(Q, T)
        q.update(aq=scratch(rows * max(D, Fd), dtype=torch.int8),
                 a_scale=scratch(rows, dtype=torch.float32))
        for name, (w8, scale, w8t) in qw.items():
            if w8t is None or w8t.device != dev:
                raise ValueError(f"{name}: W8A8 weights not on {dev}")
            f8, fs = _QFIELDS[name]
            q[f8], q[fs] = w8t, scale.contiguous()
    quant = sum(_QBITS[n] for n in qw)
    f32 = {}
    kslice = [0] * 5
    if cdt == torch.float32:
        # the split-K products share one workspace and one set of tile
        # counters: they run one after another on the stream
        shapes = _product_shapes(B, Q, NKV, T, D, Fd)
        kslice = [gemm_f32_config(*shape) for shape in shapes]
        split_k = [(-(-k // ks), rows, n) for ks, (rows, n, k)
                   in zip(kslice, shapes) if ks and ks < k]
        if split_k:
            f32 = {"f32_ws": scratch(max(s * r * n for s, r, n in split_k),
                                     dtype=torch.float32),
                   "f32_tiles": torch.zeros(
                       max(-(-n // F32_TILE_N) for _, _, n in split_k),
                       dtype=torch.int32, device=dev)}

    args = _Args(
        struct_size=ctypes.sizeof(_Args),
        dtype=1 if cdt == torch.bfloat16 else 0,
        B=B, L=L, D=D, H=H, F=Fd, U=U, R=R, M=M, Lc=Lc,
        use_mem=int(use_mem), tanh_on_mem=int(tanh_on_mem),
        activation=_ACTS[activation], quant=quant,
        init_memrow=int(init_memrow), neg_inf=float(neg_inf),
        x=_ptr(x), length=_ptr(length), reset=_ptr(reset),
        advance=_ptr(advance), mem_in=_ptr(mem), lck_in=_ptr(lc_k),
        lcv_in=_ptr(lc_v),
        **{_WFIELDS[n]: _ptr(t) for n, t in w.items()},
        y=_ptr(y), mem_out=_ptr(new_mem), lck_out=_ptr(new_lck),
        lcv_out=_ptr(new_lcv), memrow=_ptr(memrow),
        **{k: _ptr(v) for k, v in s.items()},
        **{k: _ptr(v) for k, v in q.items()},
        f32_kslice=(ctypes.c_int32 * 5)(*kslice),
        **{k: _ptr(v) for k, v in f32.items()},
        stream=torch.cuda.current_stream(dev).cuda_stream)
    _cuda.launch(dev, entry, entry, ctypes.byref(args))
    return y, new_mem, new_lck, new_lcv, s["hin"]


def w8a8_linear(x2d: torch.Tensor, q: tuple, bias: torch.Tensor,
                cdt: torch.dtype, activation: Optional[str] = None,
                config: Optional[int] = None,
                main_loop_only: bool = False) -> torch.Tensor:
    """One W8A8 product with the kernel's epilogue,
    act(_qdot(x2d, w8, scale).to(cdt) + bias.to(cdt)), for tests and
    timing.  x2d [rows, K] f32 or cdt; q = (w8, scale, w8t) from
    ``quantized_weights``.  CUDA tensor -> the row quantiser
    (``quantize_rows``' kernel) and the int8 wgmma GEMM of
    csrc/emformer_stack.cu on the tile ``run_layer`` picks,
    or on ``GEMM_TILES[config]``; CPU tensor -> plain version.
    ``main_loop_only`` (timing on the card) runs the GEMM without its
    epilogue: the output is left unwritten."""
    _check_config(config, "w8a8_linear")
    _check_main_loop_only(main_loop_only, x2d, "w8a8_linear")
    if x2d.device.type == "cpu":
        y = _qdot(x2d.to(torch.float32), q[0], q[1]).to(cdt) + bias.to(cdt)
        return _act(activation)(y) if activation else y
    if x2d.device.type != "cuda":
        raise ValueError(f"w8a8_linear: unsupported device {x2d.device}")
    _cuda.refuse_grad("w8a8_linear", x2d, bias)
    w8t, scale = q[2], q[1].contiguous()
    M, K = x2d.shape
    N = w8t.shape[0]
    if cdt not in (torch.bfloat16, torch.float32) or K % 16 or N % 8 or \
            tuple(w8t.shape) != (N, K):
        raise ValueError(f"w8a8_linear: x {tuple(x2d.shape)}, w8t "
                         f"{tuple(w8t.shape)}, {cdt} (K must be a multiple "
                         f"of 16, N of 8)")
    x_f32 = x2d.dtype == torch.float32 or cdt == torch.float32
    x2d = x2d.to(torch.float32 if x_f32 else cdt).contiguous()
    bias = bias.to(cdt).contiguous()
    aq = torch.empty((M, K), dtype=torch.int8, device=x2d.device)
    a_scale = torch.empty(M, dtype=torch.float32, device=x2d.device)
    y = torch.empty((M, N), dtype=cdt, device=x2d.device)
    _cuda.launch(
        x2d.device, "asr_w8a8_linear", "w8a8_linear",
        1 if cdt == torch.bfloat16 else 0, int(x_f32), x2d.data_ptr(),
        aq.data_ptr(), a_scale.data_ptr(), w8t.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), y.data_ptr(), M, N, K,
        _act_code(activation, main_loop_only),
        -1 if config is None else config,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    return y


def quantize_rows(x2d: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The W8A8 row quantiser alone, as ``run_layer`` runs it on out's and
    ffn2's rows, for tests and timing: x2d [M, K] f32 or bf16 -> (xq int8
    [M, K], s f32 [M]), ``quantize_rows_plain``'s values.  CUDA tensor ->
    quantize_rows_kernel of csrc/emformer_stack.cu (entry
    asr_quantize_rows: a warp a row held in registers, 16-byte loads and
    stores; a row that does not split into 16-byte chunks of its lanes'
    registers, or a misaligned one, takes the kernel's scalar path); CPU
    tensor -> ``quantize_rows_plain``."""
    if x2d.device.type == "cpu":
        return quantize_rows_plain(x2d)
    if x2d.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x2d.device}")
    _cuda.refuse_grad("quantize_rows", x2d)
    if x2d.dim() != 2 or x2d.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_rows: x {tuple(x2d.shape)} {x2d.dtype} "
                         f"(2-d, f32 or bf16)")
    M, K = x2d.shape
    x2d = x2d.contiguous()
    xq = torch.empty((M, K), dtype=torch.int8, device=x2d.device)
    xs = torch.empty(M, dtype=torch.float32, device=x2d.device)
    _cuda.launch(x2d.device, "asr_quantize_rows", "quantize_rows",
                 int(x2d.dtype == torch.float32), x2d.data_ptr(),
                 xq.data_ptr(), xs.data_ptr(), M, K,
                 torch.cuda.current_stream(x2d.device).cuda_stream)
    return xq, xs


def gemm_bf16_plain(x2d: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    activation: Optional[str] = None) -> torch.Tensor:
    """The plain version of one bf16 product of the chain, the kernel's
    epilogue (``epilogue<bf16>``): x2d [M, K] . w [K, N] in f32 rounded
    to bf16 once, the bias added in bf16, then the activation, rounded."""
    y = _mm(x2d, w, torch.bfloat16) + bias.to(torch.bfloat16)
    return _act(activation)(y) if activation else y


def gemm_bf16_error_bound(x2d: torch.Tensor, w: torch.Tensor,
                          want: torch.Tensor,
                          activation: Optional[str] = None) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for one bf16 product, where
    only the f32 sum order differs.  The two f32 sums differ by at most
    2 K u sum|x w| (u = 2^-24), so the products rounded to bf16 land at
    most one ulp (of the larger of the product and the output) apart;
    adding the bf16 bias can make that a tie that rounds to even the other
    way: two ulps.  An activation carries it through its slope (at most
    1.13 for GELU, 1.1 for SiLU) and rounds again: twice that."""
    xf, wf = x2d.float(), w.float()
    acc = torch.matmul(xf, wf)
    slack = 2.0 * x2d.shape[1] * 2.0 ** -24 * torch.matmul(xf.abs(), wf.abs())
    mag = torch.maximum(acc.abs(), want.float().abs()).clamp(min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (2 * ulp + slack) * (2 if activation else 1)


def _product_shapes(B, Q, NKV, T, D, Fd):
    """(rows, N, K) of the chain's five products, in the kernel's order
    q, kv, out, ffn1, ffn2."""
    return [(B * Q, D, D), (B * NKV, 2 * D, D), (B * Q, D, D),
            (B * T, Fd, D), (B * T, D, Fd)]


# the f32 product's split-K kernel (csrc/emformer_stack.cu, f32small): a
# block of 8 warps over 32 columns, each warp k_slice / 8 rows of K.  Its
# limits are checked here alone (gemm_f32_config, _check_f32_kslice)
F32_SMALL_ROWS = 128      # rows it holds; a product with more is tiled
F32_TILE_N = 32           # columns a block owns
F32_WARPS = 8
F32_MAX_KW = 16           # k-rows of W a lane holds in registers
F32_MAX_SPLITS = 16       # K splits the last block of a tile sums at once
F32_BLOCKS = 264          # blocks a product aims for: two per SM of 132


def gemm_f32_config(M: int, N: int, K: int) -> int:
    """How ``run_layer`` runs an [M, K] x [K, N] f32 product: the k-slice
    of the split-K kernel, or 0 for the tiled kernel (64x64 tiles, each
    K-serial).  Up to ``F32_SMALL_ROWS`` rows, with N and K multiples of 4
    and K at most ``F32_MAX_SPLITS`` slices, the split-K kernel: N tiles
    of 32 columns times ceil(K / k_slice) slices of K, the slice the power
    of two (32 to 128 rows: 4 to 16 a warp) that gives about
    ``F32_BLOCKS`` blocks, or the multiple of 32 that keeps the slices to
    ``F32_MAX_SPLITS``.  The split depends on (N, K) only, never on M, so
    a row's bits do not depend on the rows beside it.  Anything else is
    tiled."""
    if M <= 0 or N <= 0 or K <= 0:
        raise ValueError(f"gemm_f32_config: empty product {M}x{K}x{N}")
    max_slice = F32_MAX_KW * F32_WARPS
    if M > F32_SMALL_ROWS or N % 4 or K % 4 or \
            K > F32_MAX_SPLITS * max_slice:
        return 0
    want = -(-F32_BLOCKS // -(-N // F32_TILE_N))      # splits wanted
    k_slice = 1 << max(0, -(-K // want) - 1).bit_length()
    # no more than F32_MAX_SPLITS slices, each a multiple of 4 per warp
    fewest = -(-K // F32_MAX_SPLITS)
    k_slice = max(k_slice, -(-fewest // (4 * F32_WARPS)) * 4 * F32_WARPS)
    return min(max(k_slice, 4 * F32_WARPS), max_slice)


def _check_f32_kslice(k_slice: int, M: int, N: int, K: int) -> None:
    """Raise unless the split-K kernel with this k-slice (or, for 0, the
    tiled one) can run an [M, K] x [K, N] product."""
    if k_slice == 0:
        return
    if M > F32_SMALL_ROWS or N % 4 or K % 4 or k_slice < 0 or \
            k_slice % (4 * F32_WARPS) or k_slice > F32_MAX_KW * F32_WARPS \
            or -(-K // k_slice) > F32_MAX_SPLITS:
        raise ValueError(f"gemm_f32: k-slice {k_slice} cannot run "
                         f"{M}x{K}x{N} (the split-K kernel takes up to "
                         f"{F32_SMALL_ROWS} rows, N and K multiples of 4, a "
                         f"k-slice a multiple of {4 * F32_WARPS} up to "
                         f"{F32_MAX_KW * F32_WARPS}, and up to "
                         f"{F32_MAX_SPLITS} slices)")


def gemm_f32_plain(x2d: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   activation: Optional[str] = None,
                   splits: int = 0) -> torch.Tensor:
    """The plain version of one f32 product of the chain (``epilogue<float>``):
    x2d [M, K] . w [K, N] in f32, plus the bias, then the activation.
    With ``splits`` (a k-slice from ``gemm_f32_config``, not 0), the K
    slices are multiplied apart and summed in the kernel's order, slice 0
    first."""
    x2d, w = x2d.float(), w.float()
    if not splits:
        y = torch.matmul(x2d, w)
    else:
        ks = splits
        y = torch.matmul(x2d[:, :ks], w[:ks])
        for k0 in range(ks, x2d.shape[1], ks):
            y = y + torch.matmul(x2d[:, k0:k0 + ks], w[k0:k0 + ks])
    y = y + bias.float()
    return _act(activation)(y) if activation else y


def gemm_f32_error_bound(x2d: torch.Tensor, w: torch.Tensor,
                         want: torch.Tensor,
                         activation: Optional[str] = None) -> torch.Tensor:
    """Elementwise bound on |kernel - plain| for one f32 product, where
    only the f32 sum order differs: two orders differ by at most
    2 K u sum|x w| (u = 2^-24), and adding the bias rounds once more (an
    ulp of the larger of the sum and the output).  An activation carries
    it through its slope (at most 1.13 for GELU, 1.1 for SiLU) and rounds
    again: twice that."""
    xf, wf = x2d.float(), w.float()
    slack = 2.0 * x2d.shape[1] * 2.0 ** -24 * torch.matmul(xf.abs(), wf.abs())
    mag = torch.maximum(torch.matmul(xf, wf).abs(), want.float().abs())
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp(min=2.0 ** -126))) - 23)
    return (slack + ulp) * (2 if activation else 1)


def gemm_f32(x2d: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             activation: Optional[str] = None,
             config: Optional[int] = None) -> torch.Tensor:
    """One f32 product of the chain as ``run_layer`` runs it, for tests
    and timing: x2d [M, K], w [K, N] (``[in, out]``), bias [N] -> [M, N]
    f32.  CUDA tensor -> csrc/emformer_stack.cu (entry asr_gemm_f32) with
    the k-slice ``gemm_f32_config`` picks, or ``config`` (0: the tiled
    kernel); CPU tensor -> ``gemm_f32_plain``."""
    M, K = x2d.shape
    N = w.shape[-1]
    if M <= 0 or tuple(w.shape) != (K, N) or tuple(bias.shape) != (N,):
        raise ValueError(f"gemm_f32: x {tuple(x2d.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}")
    ks = gemm_f32_config(M, N, K) if config is None else config
    _check_f32_kslice(ks, M, N, K)
    if x2d.device.type == "cpu":
        return gemm_f32_plain(x2d, w, bias, activation)
    if x2d.device.type != "cuda":
        raise ValueError(f"gemm_f32: unsupported device {x2d.device}")
    _cuda.refuse_grad("gemm_f32", x2d, w, bias)
    dev = x2d.device
    x2d = x2d.to(torch.float32).contiguous()
    w = _kernel_tensor(w, torch.float32)
    bias = bias.to(torch.float32).contiguous()
    y = torch.empty((M, N), dtype=torch.float32, device=dev)
    ws = tiles = None
    splits = -(-K // ks) if ks else 1
    if splits > 1:
        ws = torch.empty(splits * M * N, dtype=torch.float32, device=dev)
        tiles = torch.zeros(-(-N // F32_TILE_N), dtype=torch.int32,
                            device=dev)
    _cuda.launch(
        dev, "asr_gemm_f32", "gemm_f32", x2d.data_ptr(), w.data_ptr(),
        bias.data_ptr(), y.data_ptr(), _ptr(ws), _ptr(tiles), M, N, K,
        _ACTS[activation] if activation else 0, ks,
        torch.cuda.current_stream(dev).cuda_stream)
    return y


# the wgmma GEMM's tile configurations (rows x columns of the tile one
# consumer warpgroup owns), by index; the bf16 and the int8 (W8A8)
# products take the same ones
GEMM_TILES = ((128, 128), (64, 128))
# the activation code that runs the GEMM's main loop alone (kActSkip)
_MAIN_LOOP_ONLY = -1


def _check_config(config: Optional[int], what: str) -> None:
    if config is not None and config not in range(len(GEMM_TILES)):
        raise ValueError(f"{what}: config {config} not in "
                         f"0..{len(GEMM_TILES) - 1}")


def _check_main_loop_only(main_loop_only: bool, x: torch.Tensor,
                          what: str) -> None:
    if main_loop_only and x.device.type != "cuda":
        raise ValueError(f"{what}: main_loop_only times the kernel on the "
                         f"card; {x.device} has none")


def _act_code(activation: Optional[str], main_loop_only: bool) -> int:
    if main_loop_only:
        return _MAIN_LOOP_ONLY
    return _ACTS[activation] if activation else 0


def gemm_config(M: int, N: int,
                pair: Optional[Tuple[int, int]] = None) -> int:
    """The index in ``GEMM_TILES`` of the tile ``run_layer``'s GEMM takes
    on this card for an [M, N] product (bf16 or W8A8 alike: the choice
    reads the shapes alone), or for it and a ``pair = (M1, N1)`` product
    in one launch (a layer's q and kv): the least ``gemm_load_span``, the
    larger tile on a tie (``gemm_config`` in csrc/emformer_stack.cu)."""
    M1, N1 = pair if pair else (0, 0)
    rc = _cuda.lib().asr_gemm_config(M, N, M1, N1)
    _cuda.check(min(rc, 0), "gemm_config")
    return rc


def gemm_load_span(shapes: Sequence[Tuple[int, int]], config: int,
                   sms: int) -> int:
    """What ``gemm_config`` minimises for one launch of the [M, N]
    products ``shapes``: the bytes the busiest SM loads for the main
    loops, per 128 bytes of K, on ``GEMM_TILES[config]``: rounds of the
    products' tiles over ``sms`` SMs (one block an SM) times a tile's rows
    and columns."""
    wm, bn = GEMM_TILES[config]
    tiles = sum(-(-M // wm) * -(-N // bn) for M, N in shapes)
    return -(-tiles // sms) * (wm + bn)


def gemm_bf16(x2d: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
              activation: Optional[str] = None,
              config: Optional[int] = None,
              main_loop_only: bool = False) -> torch.Tensor:
    """One bf16 product of the chain as ``run_layer`` runs it, for tests
    and timing: x2d [M, K], w [K, N] (``[in, out]``; the kernel reads its
    transposed copy, made once per weight tensor), bias [N] -> [M, N]
    bf16.  CUDA tensor -> the wgmma GEMM of csrc/emformer_stack.cu on the
    tile ``run_layer`` picks, or on ``GEMM_TILES[config]``; CPU tensor ->
    ``gemm_bf16_plain``.  ``main_loop_only`` (timing on the card) runs
    the GEMM without its epilogue: the output is left unwritten."""
    _check_config(config, "gemm_bf16")
    _check_main_loop_only(main_loop_only, x2d, "gemm_bf16")
    if x2d.device.type == "cpu":
        return gemm_bf16_plain(x2d, w, bias, activation)
    if x2d.device.type != "cuda":
        raise ValueError(f"gemm_bf16: unsupported device {x2d.device}")
    _cuda.refuse_grad("gemm_bf16", x2d, w, bias)
    M, K = x2d.shape
    N = w.shape[-1]
    if K % 8 or N % 8 or tuple(w.shape) != (K, N) or \
            tuple(bias.shape) != (N,):
        raise ValueError(f"gemm_bf16: x {tuple(x2d.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)} (K and "
                         f"N must be multiples of 8)")
    x2d = x2d.to(torch.bfloat16).contiguous()
    wt = _kernel_tensor(w, torch.bfloat16, transpose=True)
    bias = bias.to(torch.bfloat16).contiguous()
    y = torch.empty((M, N), dtype=torch.bfloat16, device=x2d.device)
    _cuda.launch(
        x2d.device, "asr_gemm_bf16", "gemm_bf16", x2d.data_ptr(),
        wt.data_ptr(), bias.data_ptr(), y.data_ptr(), M, N, K,
        _act_code(activation, main_loop_only),
        -1 if config is None else config,
        torch.cuda.current_stream(x2d.device).cuda_stream)
    return y


def gemm_act_table(activation: str, device: torch.device) -> torch.Tensor:
    """The card's table of the bf16 GEMM epilogue's activation ("gelu" or
    "silu"): [65536] int16, entry h the bits of round(act(v)) for the bf16
    v with bits h, as the kernel's epilogue must give them (for tests)."""
    if activation not in ("gelu", "silu") or device.type != "cuda":
        raise ValueError(f"gemm_act_table: {activation} on {device}")
    out = torch.empty(65536, dtype=torch.int16, device=device)
    _cuda.launch(device, "asr_gemm_act_table", "gemm_act_table",
                 _ACTS[activation], out.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    return out


def gemm_bf16_pair(x0: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                   x1: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                   config: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two bf16 products with the same K in one launch, as ``run_layer``
    runs a layer's q and kv products (no activation), for tests and
    timing: (x0 . w0 + b0, x1 . w1 + b1).  CUDA tensors -> the wgmma GEMM
    over both products' tiles (entry asr_gemm_bf16_pair) on the tile
    ``gemm_config(..., pair=...)`` picks or ``GEMM_TILES[config]``; CPU
    tensors -> ``gemm_bf16_plain`` twice."""
    _check_config(config, "gemm_bf16_pair")
    if x0.device.type == "cpu":
        return gemm_bf16_plain(x0, w0, b0), gemm_bf16_plain(x1, w1, b1)
    if x0.device.type != "cuda":
        raise ValueError(f"gemm_bf16_pair: unsupported device {x0.device}")
    _cuda.refuse_grad("gemm_bf16_pair", x0, w0, b0, x1, w1, b1)
    K = x0.shape[1]
    ops = []
    for x, w, b in ((x0, w0, b0), (x1, w1, b1)):
        M, N = x.shape[0], w.shape[-1]
        if K % 8 or N % 8 or tuple(x.shape) != (M, K) or \
                tuple(w.shape) != (K, N) or tuple(b.shape) != (N,):
            raise ValueError(f"gemm_bf16_pair: x {tuple(x.shape)}, w "
                             f"{tuple(w.shape)}, bias {tuple(b.shape)} (one "
                             f"K, a multiple of 8; N a multiple of 8)")
        ops.append((x.to(torch.bfloat16).contiguous(),
                    _kernel_tensor(w, torch.bfloat16, transpose=True),
                    b.to(torch.bfloat16).contiguous(),
                    torch.empty((M, N), dtype=torch.bfloat16,
                                device=x.device), M, N))
    args = []
    for x, wt, b, y, M, N in ops:
        args += [x.data_ptr(), wt.data_ptr(), b.data_ptr(), y.data_ptr(), M, N]
    _cuda.launch(x0.device, "asr_gemm_bf16_pair", "gemm_bf16_pair", *args, K,
                 -1 if config is None else config,
                 torch.cuda.current_stream(x0.device).cuda_stream)
    return ops[0][3], ops[1][3]


def _emformer_stack_cuda(params, x, mem, lc_k, lc_v, length, reset, advance,
                         *, quant, **kw):
    global LAUNCHES, LAUNCHES_INT8
    _cuda.refuse_grad("emformer_stack", params, x, mem, lc_k, lc_v)
    names = _kernel_quant_names(quant)
    w = kernel_weights(params, kw["cdt"], skip=names)
    qw = quantized_weights(params, names)
    memrow = torch.empty((x.shape[0], x.shape[2]), dtype=torch.float32,
                         device=x.device)
    y, new_mem, new_lck, new_lcv, _ = run_chain(
        "asr_emformer_stack", w, qw, x, length, reset, advance, mem, lc_k,
        lc_v, memrow, **kw)
    if names:
        LAUNCHES_INT8 += 1
    else:
        LAUNCHES += 1
    return y, new_mem, new_lck, new_lcv


def emformer_stack(params: dict, x: torch.Tensor, mem: torch.Tensor,
                   lc_k: torch.Tensor, lc_v: torch.Tensor,
                   length: torch.Tensor,
                   reset: Optional[torch.Tensor] = None,
                   advance: Optional[torch.Tensor] = None, *,
                   U: int, R: int, M: int, Lc: int, H: int, use_mem: bool,
                   tanh_on_mem: bool, neg_inf: float, activation: str,
                   cdt: torch.dtype, quant="none"
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """All-layer Emformer step (see module doc).  CUDA tensor -> kernel,
    CPU tensor -> plain version."""
    B = x.shape[0]
    if reset is None:
        reset = torch.zeros(B, dtype=torch.bool, device=x.device)
    if advance is None:
        advance = torch.ones(B, dtype=torch.bool, device=x.device)
    kw = dict(U=U, R=R, M=M, Lc=Lc, H=H, use_mem=use_mem,
              tanh_on_mem=tanh_on_mem, neg_inf=neg_inf,
              activation=activation, cdt=cdt)
    if x.device.type == "cuda":
        return _emformer_stack_cuda(params, x, mem, lc_k, lc_v, length,
                                    reset, advance, quant=quant, **kw)
    if x.device.type == "cpu":
        return emformer_stack_plain(params, x, mem, lc_k, lc_v, length,
                                    reset.bool(), advance.bool(),
                                    quant=quant, **kw)
    raise ValueError(f"emformer_stack: unsupported device {x.device}")


# ------------------------------------------------- the chain's row kernels
# Each row kernel of csrc/emformer_stack.cu alone, as run_layer launches it
# (C entry asr_emformer_rows), for tests and timing, with its plain
# version: ``rows_first`` (the first layer's input), ``rows_residual``
# (after the out product: the FFN LN, with the left-context half of the
# state roll), ``rows_boundary`` (after ffn2: this layer's output LN of
# out + hin + h2, then the next layer's input LN and the memory half of
# its roll), ``rows_last`` (the last layer's output LN).  The plain
# versions compute what ``_layer_plain`` computes, split as the kernels
# split it.  CUDA tensors launch the kernel, CPU tensors run the plain
# version.  In W8A8 (``quant``, as ``emformer_stack`` takes it) a row
# kernel writes the q, kv and ffn1 products' operands as int8 rows with
# their scales, ``quantize_rows_plain``'s values, in place of the
# compute-type rows: its output ``q8`` is {product: (int8 rows [B, rows,
# D], scales [B, rows])} and the compute-type output of a quantised
# product is None.

_ROW_KINDS = {"first": 0, "residual": 1, "boundary": 2, "last": 3}
# the library's launch counters (asr_launch_counts), in its order
_COUNTED = tuple(f"rows_{k}" for k in _ROW_KINDS) + (
    "quantize_rows", "gemm_int8", "gemm_bf16", "attention")
_RELAUNCH = None      # rows_relaunch's list while it runs a wrapper


def _row_quant(quant, names) -> tuple:
    """The products among ``names`` that ``quant`` runs W8A8."""
    return tuple(n for n in names if n in _kernel_quant_names(quant))


def _rows_in(utt, rc, mem, memrow, reset, advance, scale, bias, *, use_mem,
             cdt, quant):
    """A layer's input LN of its rows utt [B, U, D] and rc [B, R, D] (f32):
    (q_in [B, Q, D] and kv_in [B, M+T, D] in ``cdt``, each None where it
    is quantised; q8, the quantised ones' int8 rows and scales; the memory
    half of the layer's roll [B, M, D] from ``mem`` and the layer's input
    memory row ``memrow`` [B, D])."""
    B = utt.shape[0]
    ln_rc = _ln(rc, scale, bias)
    ln_utt = _ln(utt, scale, bias)
    parts = [ln_rc, ln_utt]
    if use_mem:
        parts.append(ln_utt.mean(1, keepdim=True))
    q_in32 = torch.cat(parts, 1)
    reset3, adv3 = reset.view(B, 1, 1), advance.view(B, 1, 1)
    mem_state = torch.where(reset3, torch.zeros_like(mem), mem)
    kv_in = torch.cat(([mem_state.to(cdt)] if use_mem else [])
                      + [ln_rc.to(cdt), ln_utt.to(cdt)], 1)
    mem_out = mem_state
    if use_mem:
        rolled = torch.cat([mem_state[:, 1:],
                            memrow.view(B, 1, -1).to(mem.dtype)], 1)
        mem_out = torch.where(adv3, rolled, mem_state)
    names = _row_quant(quant, ("w_q", "w_kv"))
    rows = {"w_q": q_in32, "w_kv": kv_in}
    q8 = {n: quantize_rows_plain(rows[n]) for n in names}
    return (None if "w_q" in names else q_in32.to(cdt),
            None if "w_kv" in names else kv_in, q8, mem_out)


def rows_first_plain(x, mem, reset, advance, scale, bias, memrow=None, *, U,
                     R, use_mem, cdt, quant="none"):
    """The plain version of ``rows_first``."""
    xf = x.to(torch.float32)
    utt, rc = xf[:, :U], xf[:, U:U + R]
    if use_mem and memrow is None:
        memrow = utt.mean(1)
    q_in, kv_in, q8, mem_out = _rows_in(
        utt, rc, mem, memrow, reset.bool(), advance.bool(), scale, bias,
        use_mem=use_mem, cdt=cdt, quant=quant)
    return (torch.cat([rc, utt], 1), q_in, kv_in, q8,
            memrow if use_mem else None, mem_out)


def rows_residual_plain(out, hin, kv, lc_k, lc_v, reset, advance, scale,
                        bias, *, U, R, M, Lc, use_mem, tanh_on_mem,
                        quant="none"):
    """The plain version of ``rows_residual``."""
    B, T, D = hin.shape
    cdt = out.dtype
    ff = _ln(out[:, :T].float() + hin, scale, bias)
    memrow = None
    if use_mem:
        m = out[:, T].float()
        memrow = torch.tanh(m) if tanh_on_mem else torch.clamp(m, -10.0, 10.0)
    reset3, adv3 = reset.bool().view(B, 1, 1), advance.bool().view(B, 1, 1)
    keep = max(0, Lc - U)
    rolled = []
    for lc, new in ((lc_k, kv[:, M + R:, :D]), (lc_v, kv[:, M + R:, D:])):
        lc0 = torch.where(reset3, torch.zeros_like(lc), lc).to(cdt)
        shifted = torch.cat([lc0[:, Lc - keep:], new[:, U - (Lc - keep):]],
                            1).to(lc.dtype)
        rolled.append(torch.where(adv3, shifted, lc0.to(lc.dtype)))
    if _row_quant(quant, ("ff_w1",)):
        return (None, {"ff_w1": quantize_rows_plain(ff)}, memrow, *rolled)
    return (ff.to(cdt), {}, memrow, *rolled)


def _output_ln(out, hin, h2, scale, bias):
    """The layer's output LN of its residual out + hin and the FFN's h2."""
    T = hin.shape[1]
    return _ln((out[:, :T].float() + hin) + h2.float(), scale, bias)


def rows_boundary_plain(out, hin, h2, mem, memrow, reset, advance, out_scale,
                        out_bias, in_scale, in_bias, *, U, R, use_mem,
                        quant="none"):
    """The plain version of ``rows_boundary``."""
    hin = _output_ln(out, hin, h2, out_scale, out_bias)
    q_in, kv_in, q8, mem_out = _rows_in(
        hin[:, R:], hin[:, :R], mem, memrow, reset.bool(), advance.bool(),
        in_scale, in_bias, use_mem=use_mem, cdt=h2.dtype, quant=quant)
    return hin, q_in, kv_in, q8, mem_out


def rows_last_plain(out, hin, h2, scale, bias, *, U, R):
    """The plain version of ``rows_last``."""
    hin = _output_ln(out, hin, h2, scale, bias)
    return hin, hin[:, R:]


def _check_rows(what, dev, **tensors):
    """Raise unless each named (tensor, shape, dtype) is as given and on
    ``dev``."""
    for name, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or \
                t.device != dev:
            raise ValueError(f"{what}: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {tuple(shape)} "
                             f"{dtype} on {dev}")


def _int8_rows(names, dev, **rows):
    """{product: (int8 rows [B, n, D], scales [B, n])} on ``dev`` for the
    ``names`` among ``rows`` ({product: (B, n, D)})."""
    return {n: (torch.empty(rows[n], dtype=torch.int8, device=dev),
                torch.empty(rows[n][:2], dtype=torch.float32, device=dev))
            for n in names}


def _launch_rows(kind, dev, cdt, *, B, D, U, R, M=0, Lc=0, tanh_on_mem=False,
                 init_memrow=False, q8=None, **tensors):
    """Launch one row kernel (entry asr_emformer_rows) on the tensors named
    by their ``_Args`` fields, with the int8 rows and scales of the
    products in ``q8``."""
    for name, (rows, scales) in (q8 or {}).items():
        f8, fs, _ = _ROW_QUANT[name]
        tensors[f8], tensors[fs] = rows, scales
    if cdt not in (torch.bfloat16, torch.float32) or D > 1024:
        raise ValueError(f"rows_{kind}: {cdt}, D={D} (bf16 or f32, D <= "
                         f"1024)")
    if not all(t is None or t.is_contiguous() for t in tensors.values()):
        raise ValueError(f"rows_{kind}: every tensor must be contiguous")
    _check_vectors(f"rows_{kind}", cdt, D, **tensors)
    args = _Args(
        struct_size=ctypes.sizeof(_Args),
        dtype=1 if cdt == torch.bfloat16 else 0, B=B, L=1, D=D, H=1, U=U,
        R=R, M=M, Lc=Lc, use_mem=int(M > 0), tanh_on_mem=int(tanh_on_mem),
        quant=sum(_QBITS[n] for n in q8 or {}),
        init_memrow=int(init_memrow),
        **{k: _ptr(t) for k, t in tensors.items()},
        stream=torch.cuda.current_stream(dev).cuda_stream)

    def launch(keep=tensors):   # keep: args' tensors live as long as it
        _cuda.launch(dev, "asr_emformer_rows", f"rows_{kind}",
                     ctypes.byref(args), _ROW_KINDS[kind])

    launch()
    if _RELAUNCH is not None:
        _RELAUNCH.append(launch)


def kernel_launch_counts() -> dict:
    """The launches in this process of the row kernels ("rows_first", ...),
    the W8A8 row quantiser ("quantize_rows"), the int8 and bf16 wgmma
    GEMMs ("gemm_int8", "gemm_bf16") and the attention ("attention"),
    counted by the library on the host as each launch is queued, so that a
    profile that drops kernel records cannot hide one; needs the CUDA
    library."""
    counts = (ctypes.c_longlong * len(_COUNTED))()
    n = _cuda.lib().asr_launch_counts(counts)
    if n != len(_COUNTED):
        raise RuntimeError(f"asr_launch_counts: {n} counters, expected "
                           f"{len(_COUNTED)}")
    return dict(zip(_COUNTED, counts))



def rows_relaunch(wrapper, *args, **kw):
    """Call a row kernel's wrapper (``rows_first`` ... ``rows_last``) on
    CUDA tensors and return (its outputs, a callable that launches the same
    kernel again on the same buffers and queues nothing else: no copy, no
    allocation), to time the kernel alone.  A relaunch of ``rows_boundary``
    or ``rows_last`` takes the LN of the hin it wrote before: other values,
    the same work."""
    global _RELAUNCH
    _RELAUNCH = []
    try:
        out = wrapper(*args, **kw)
        (launch,) = _RELAUNCH
    finally:
        _RELAUNCH = None
    return out, launch


def _flags(reset, advance, dev):
    return (reset.to(device=dev, dtype=torch.uint8).contiguous(),
            advance.to(device=dev, dtype=torch.uint8).contiguous())


def _device(t, what):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _input_rows(quant, dev, cdt, B, Q, NKV, D):
    """A layer's input rows as rows_first and rows_boundary write them:
    (q_in [B, Q, D], kv_in [B, NKV, D], each None where ``quant`` runs its
    product W8A8; q8, the int8 rows and scales of those)."""
    names = _row_quant(quant, ("w_q", "w_kv"))
    q8 = _int8_rows(names, dev, w_q=(B, Q, D), w_kv=(B, NKV, D))
    return (None if "w_q" in names else
            torch.empty((B, Q, D), dtype=cdt, device=dev),
            None if "w_kv" in names else
            torch.empty((B, NKV, D), dtype=cdt, device=dev), q8)


def rows_first(x, mem, reset, advance, scale, bias, memrow=None, *, U, R,
               use_mem, cdt, quant="none"):
    """The first layer's input rows: x [B, U+R, D] f32 (utterance then
    right context), its memory state mem [B, M, D] in ``cdt``, the masks
    [B], its input LN (scale, bias [D] f32) and its input memory row
    memrow [B, D] f32 (None: the mean of the raw utterance, as the stack
    computes it).  Returns (hin [B, T, D] f32 rows [rc; utt], q_in
    [B, Q, D], kv_in [B, M+T, D], q8 (W8A8: q's and kv's int8 rows, in
    place of q_in and kv_in), the memory row (None without memory), the
    rolled memory [B, M, D])."""
    if not _device(x, "rows_first"):
        return rows_first_plain(x, mem, reset, advance, scale, bias, memrow,
                                U=U, R=R, use_mem=use_mem, cdt=cdt,
                                quant=quant)
    _cuda.refuse_grad("rows_first", x, mem, scale, bias, memrow)
    dev, (B, T, D), M = x.device, x.shape, mem.shape[1]
    if T != U + R or use_mem != (M > 0):
        raise ValueError(f"rows_first: x {tuple(x.shape)}, U={U}, R={R}, "
                         f"M={M}, use_mem={use_mem}")
    Q = T + int(use_mem)
    init = use_mem and memrow is None
    if not use_mem:
        memrow = None
    elif init:
        memrow = torch.empty((B, D), dtype=torch.float32, device=dev)
    else:
        memrow = memrow.to(torch.float32).contiguous()
    _check_rows("rows_first", dev, mem=(mem, (B, M, D), cdt),
                scale=(scale, (D,), torch.float32),
                bias=(bias, (D,), torch.float32),
                **({"memrow": (memrow, (B, D), torch.float32)}
                   if use_mem else {}))
    reset, advance = _flags(reset, advance, dev)
    hin = torch.empty((B, T, D), dtype=torch.float32, device=dev)
    q_in, kv_in, q8 = _input_rows(quant, dev, cdt, B, Q, M + T, D)
    mem_out = torch.empty_like(mem)
    _launch_rows("first", dev, cdt, B=B, D=D, U=U, R=R, M=M,
                 init_memrow=init, q8=q8,
                 x=x.to(torch.float32).contiguous(), reset=reset,
                 advance=advance, mem_in=mem.contiguous(), mem_out=mem_out,
                 lnin_s=scale, lnin_b=bias, hin=hin, q_in=q_in, kv_in=kv_in,
                 memrow=memrow)
    return hin, q_in, kv_in, q8, memrow, mem_out


def rows_residual(out, hin, kv, lc_k, lc_v, reset, advance, scale, bias, *,
                  U, R, M, Lc, use_mem, tanh_on_mem, quant="none"):
    """After the out product: out [B, Q, D] and kv [B, M+T, 2D] in the
    compute type, hin [B, T, D] f32 (the layer's input rows [rc; utt]),
    the layer's left context lc_k / lc_v [B, Lc, D], the masks and the FFN
    LN (scale, bias).  Returns (ff_in [B, T, D], the FFN LN of out + hin;
    q8 (W8A8: ffn1's int8 rows, in place of ff_in); the next memory row
    [B, D] f32 (None without memory); the rolled lc_k and lc_v)."""
    if not _device(out, "rows_residual"):
        return rows_residual_plain(out, hin, kv, lc_k, lc_v, reset, advance,
                                   scale, bias, U=U, R=R, M=M, Lc=Lc,
                                   use_mem=use_mem, tanh_on_mem=tanh_on_mem,
                                   quant=quant)
    _cuda.refuse_grad("rows_residual", out, hin, kv, lc_k, lc_v, scale, bias)
    dev, cdt, (B, T, D) = out.device, out.dtype, hin.shape
    Q = T + int(use_mem)
    if T != U + R or use_mem != (M > 0):
        raise ValueError(f"rows_residual: hin {tuple(hin.shape)}, U={U}, "
                         f"R={R}, M={M}, use_mem={use_mem}")
    _check_rows("rows_residual", dev, out=(out, (B, Q, D), cdt),
                hin=(hin, (B, T, D), torch.float32),
                kv=(kv, (B, M + T, 2 * D), cdt),
                lc_k=(lc_k, (B, Lc, D), cdt), lc_v=(lc_v, (B, Lc, D), cdt),
                scale=(scale, (D,), torch.float32),
                bias=(bias, (D,), torch.float32))
    reset, advance = _flags(reset, advance, dev)
    names = _row_quant(quant, ("ff_w1",))
    q8 = _int8_rows(names, dev, ff_w1=(B, T, D))
    ff_in = None if names else torch.empty((B, T, D), dtype=cdt, device=dev)
    memrow = torch.empty((B, D), dtype=torch.float32, device=dev) \
        if use_mem else None
    lck_out, lcv_out = torch.empty_like(lc_k), torch.empty_like(lc_v)
    _launch_rows("residual", dev, cdt, B=B, D=D, U=U, R=R, M=M, Lc=Lc,
                 tanh_on_mem=tanh_on_mem, q8=q8, out=out,
                 hin=hin, kv=kv, lck_in=lc_k, lcv_in=lc_v, reset=reset,
                 advance=advance, ffln_s=scale, ffln_b=bias, ff_in=ff_in,
                 memrow=memrow, lck_out=lck_out, lcv_out=lcv_out)
    return ff_in, q8, memrow, lck_out, lcv_out


def rows_boundary(out, hin, h2, mem, memrow, reset, advance, out_scale,
                  out_bias, in_scale, in_bias, *, U, R, use_mem,
                  quant="none"):
    """After ffn2, between two layers: the residual out [B, Q, D] (the out
    product, compute type) + hin [B, T, D] f32 (the layer's input rows)
    and h2 [B, T, D] give this layer's output LN (out_scale, out_bias),
    and its rows the next layer's input LN (in_scale, in_bias) with that
    layer's memory state mem [B, M, D] and input memory row memrow [B, D]
    f32.  Returns (the new hin [B, T, D] f32, q_in, kv_in, q8 as
    ``rows_first``'s, the next layer's rolled memory); the kernel writes
    hin where it reads it, so the wrapper hands it a copy."""
    if not _device(h2, "rows_boundary"):
        return rows_boundary_plain(out, hin, h2, mem, memrow, reset, advance,
                                   out_scale, out_bias, in_scale, in_bias,
                                   U=U, R=R, use_mem=use_mem, quant=quant)
    _cuda.refuse_grad("rows_boundary", out, hin, h2, mem, memrow, out_scale,
                      out_bias, in_scale, in_bias)
    dev, cdt, (B, T, D), M = h2.device, h2.dtype, h2.shape, mem.shape[1]
    Q = T + int(use_mem)
    if T != U + R or use_mem != (M > 0):
        raise ValueError(f"rows_boundary: h2 {tuple(h2.shape)}, U={U}, "
                         f"R={R}, M={M}, use_mem={use_mem}")
    vec = ((D,), torch.float32)
    _check_rows("rows_boundary", dev, out=(out, (B, Q, D), cdt),
                hin=(hin, (B, T, D), torch.float32),
                mem=(mem, (B, M, D), cdt), out_scale=(out_scale, *vec),
                out_bias=(out_bias, *vec), in_scale=(in_scale, *vec),
                in_bias=(in_bias, *vec),
                **({"memrow": (memrow, (B, D), torch.float32)}
                   if use_mem else {}))
    reset, advance = _flags(reset, advance, dev)
    hin = hin.clone(memory_format=torch.contiguous_format)
    q_in, kv_in, q8 = _input_rows(quant, dev, cdt, B, Q, M + T, D)
    mem_out = torch.empty_like(mem)
    _launch_rows("boundary", dev, cdt, B=B, D=D, U=U, R=R, M=M, q8=q8,
                 out=out, h2=h2, mem_in=mem,
                 mem_out=mem_out, memrow=memrow if use_mem else None,
                 reset=reset, advance=advance, lnout_s=out_scale,
                 lnout_b=out_bias, lnin_s=in_scale, lnin_b=in_bias, hin=hin,
                 q_in=q_in, kv_in=kv_in)
    return hin, q_in, kv_in, q8, mem_out


def rows_last(out, hin, h2, scale, bias, *, U, R):
    """The last layer's output LN (scale, bias) of its residual out
    [B, Q, D] + hin [B, T, D] f32 and h2 [B, T, D]: (the new hin [B, T, D]
    f32 rows [rc; utt], y [B, U, D] f32 its utterance); the kernel writes
    hin where it reads it, so the wrapper hands it a copy."""
    if not _device(h2, "rows_last"):
        return rows_last_plain(out, hin, h2, scale, bias, U=U, R=R)
    _cuda.refuse_grad("rows_last", out, hin, h2, scale, bias)
    dev, cdt, (B, T, D) = h2.device, h2.dtype, h2.shape
    if T != U + R or out.shape[1] not in (T, T + 1):
        raise ValueError(f"rows_last: h2 {tuple(h2.shape)}, out "
                         f"{tuple(out.shape)}, U={U}, R={R}")
    _check_rows("rows_last", dev, out=(out, (B, out.shape[1], D), cdt),
                hin=(hin, (B, T, D), torch.float32),
                scale=(scale, (D,), torch.float32),
                bias=(bias, (D,), torch.float32))
    hin = hin.clone(memory_format=torch.contiguous_format)
    y = torch.empty((B, U, D), dtype=torch.float32, device=dev)
    # M > 0 marks out's summary row (use_mem), which the kernel steps over
    _launch_rows("last", dev, cdt, B=B, D=D, U=U, R=R,
                 M=out.shape[1] - T, out=out, h2=h2, lnout_s=scale,
                 lnout_b=bias, hin=hin, y=y)
    return hin, y
