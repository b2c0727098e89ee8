"""All-layer streaming Emformer step: CUDA kernel wrapper + plain version.

Counterpart of asr_streaming_tpu/ops/pallas_emformer.py::fused_emformer_stack.
``emformer_stack`` takes the JAX layouts: stacked params ``[L, ...]``
(weights ``[in, out]``), x ``[B, U+R, D]`` (utterance then right context),
state mem ``[L,B,M,D]`` and lc_k/lc_v ``[L,B,Lc,D]`` in the compute type,
the RESET-EFFECTIVE length ``[B]`` and optional reset/advance ``[B]``
masks.  Returns (y ``[B,U,D]`` f32, new_mem, new_lc_k, new_lc_v).

On a CUDA tensor it launches ``csrc/emformer_stack.cu``; on a CPU tensor
it runs ``emformer_stack_plain``, which follows the Pallas kernel's
``_layer_math`` line by line (same bf16 rounding points).  Nothing else.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch.ops import _cuda

# launches of the CUDA kernel (one per call that reaches the card)
LAUNCHES = 0

_MAT = ("w_q", "w_kv", "w_out", "ff_w1", "ff_w2")
_BIAS = ("b_q", "b_kv", "b_out", "ff_b1", "ff_b2")
_LN = ("ln_in_scale", "ln_in_bias", "ff_ln_scale", "ff_ln_bias",
       "ln_out_scale", "ln_out_bias")
_ACTS = {"relu": 1, "gelu": 2, "silu": 3}


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


def _layer_plain(utt, rc, mem_row, mem_state_in, lc_k_in, lc_v_in, length,
                 reset, advance, w, *, U, R, M, Lc, H, use_mem, tanh_on_mem,
                 neg_inf, activation, cdt):
    """One layer: pallas_emformer.py::_layer_math in PyTorch."""
    B, _, D = utt.shape
    Dh = D // H
    K = M + R + Lc + U
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

    q = (_mm(q_in.reshape(B * Q, D), w["w_q"], cdt)
         + w["b_q"].to(cdt)).reshape(B, Q, D)

    mem_state = torch.where(reset3, torch.zeros_like(mem_state_in),
                            mem_state_in)
    parts = ([mem_state.to(cdt)] if use_mem else []) + [ln_rc.to(cdt),
                                                        ln_utt.to(cdt)]
    kv_in = torch.cat(parts, 1)
    n_kv = kv_in.shape[1]
    kv = (_mm(kv_in.reshape(B * n_kv, D), w["w_kv"], cdt)
          + w["b_kv"].to(cdt)).reshape(B, n_kv, 2 * D)
    k_part, v_part = kv[:, :, :D], kv[:, :, D:]
    next_k, next_v = k_part[:, M + R:], v_part[:, M + R:]

    lc_k = torch.where(reset3, torch.zeros_like(lc_k_in), lc_k_in).to(cdt)
    lc_v = torch.where(reset3, torch.zeros_like(lc_v_in), lc_v_in).to(cdt)
    full_k = torch.cat([k_part[:, :M + R], lc_k, next_k], 1)
    full_v = torch.cat([v_part[:, :M + R], lc_v, next_v], 1)

    # key validity from the per-slot fill counters
    length = length.view(B, 1).to(torch.int64)
    col = torch.arange(K, device=utt.device).view(1, K)
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
    attn = attn.transpose(1, 2).reshape(B, Q, D).to(cdt)

    out = (_mm(attn.reshape(B * Q, D), w["w_out"], cdt)
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
    h1 = _act(activation)(_mm(ff.reshape(B * T, D), w["ff_w1"], cdt)
                          + w["ff_b1"].to(cdt))
    h2 = (_mm(h1, w["ff_w2"], cdt) + w["ff_b2"].to(cdt)).reshape(B, T, D)
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
                         activation, cdt):
    """The plain PyTorch version of the kernel (any device)."""
    L = params["w_q"].shape[0]
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
            cdt=cdt)
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
                    "use_mem", "tanh_on_mem", "activation")]
                + [("neg_inf", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in (
                    "x", "length", "reset", "advance",
                    "mem_in", "lck_in", "lcv_in",
                    "wq", "bq", "wkv", "bkv", "wout", "bout",
                    "lnin_s", "lnin_b", "ffln_s", "ffln_b",
                    "w1", "b1", "w2", "b2", "lnout_s", "lnout_b",
                    "y", "mem_out", "lck_out", "lcv_out",
                    "q_in", "kv_in", "q", "kv", "attn", "out", "ff_in",
                    "h1", "h2", "hin", "hres", "memrow", "stream")])


def _kernel_weights(params: dict, cdt: torch.dtype) -> dict:
    """Stacked weights as the kernel reads them: products and biases in
    the compute type, LN vectors in f32, contiguous (a no-op when the
    params already are; f32 -> bf16 costs ~0.1 ms per step at VI width)."""
    w = {n: params[n].to(cdt).contiguous() for n in _MAT + _BIAS}
    w.update({n: params[n].float().contiguous() for n in _LN})
    return w


def _emformer_stack_cuda(params, x, mem, lc_k, lc_v, length, reset, advance,
                         *, U, R, M, Lc, H, use_mem, tanh_on_mem, neg_inf,
                         activation, cdt):
    global LAUNCHES
    dev = x.device
    L, D, _ = params["w_q"].shape
    B = x.shape[0]
    Fd = params["ff_w1"].shape[-1]
    if cdt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"emformer_stack kernel: unsupported dtype {cdt}")
    if activation not in _ACTS:
        raise ValueError(f"emformer_stack kernel: activation {activation}")
    if D > 1024 or D % H:
        raise ValueError(f"emformer_stack kernel: D={D}, H={H}")
    if cdt == torch.bfloat16 and (D % 8 or Fd % 8):
        raise ValueError(f"emformer_stack kernel: bf16 needs D and F "
                         f"multiples of 8 (D={D}, F={Fd})")
    if tuple(x.shape) != (B, U + R, D):
        raise ValueError(f"x shape {tuple(x.shape)} != {(B, U + R, D)}")
    for name, t, rows in (("mem", mem, M), ("lc_k", lc_k, Lc),
                          ("lc_v", lc_v, Lc)):
        if tuple(t.shape) != (L, B, rows, D) or t.dtype != cdt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{(L, B, rows, D)} {cdt}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
    if use_mem and M == 0:
        raise ValueError("use_mem requires M > 0")

    w = _kernel_weights(params, cdt)
    x = x.to(torch.float32).contiguous()
    mem, lc_k, lc_v = mem.contiguous(), lc_k.contiguous(), lc_v.contiguous()
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

    s = {"q_in": scratch(B, Q, D), "kv_in": scratch(B, NKV, D),
         "q": scratch(B, Q, D), "kv": scratch(B, NKV, 2 * D),
         "attn": scratch(B, Q, D), "out": scratch(B, Q, D),
         "ff_in": scratch(B, T, D), "h1": scratch(B, T, Fd),
         "h2": scratch(B, T, D),
         "hin": scratch(B, T, D, dtype=torch.float32),
         "hres": scratch(B, T, D, dtype=torch.float32),
         "memrow": scratch(B, D, dtype=torch.float32)}

    def ptr(t):
        return t.data_ptr() if t.numel() else None

    args = _Args(
        struct_size=ctypes.sizeof(_Args),
        dtype=1 if cdt == torch.bfloat16 else 0,
        B=B, L=L, D=D, H=H, F=Fd, U=U, R=R, M=M, Lc=Lc,
        use_mem=int(use_mem), tanh_on_mem=int(tanh_on_mem),
        activation=_ACTS[activation], neg_inf=float(neg_inf),
        x=ptr(x), length=ptr(length), reset=ptr(reset), advance=ptr(advance),
        mem_in=ptr(mem), lck_in=ptr(lc_k), lcv_in=ptr(lc_v),
        wq=ptr(w["w_q"]), bq=ptr(w["b_q"]), wkv=ptr(w["w_kv"]),
        bkv=ptr(w["b_kv"]), wout=ptr(w["w_out"]), bout=ptr(w["b_out"]),
        lnin_s=ptr(w["ln_in_scale"]), lnin_b=ptr(w["ln_in_bias"]),
        ffln_s=ptr(w["ff_ln_scale"]), ffln_b=ptr(w["ff_ln_bias"]),
        w1=ptr(w["ff_w1"]), b1=ptr(w["ff_b1"]), w2=ptr(w["ff_w2"]),
        b2=ptr(w["ff_b2"]), lnout_s=ptr(w["ln_out_scale"]),
        lnout_b=ptr(w["ln_out_bias"]),
        y=ptr(y), mem_out=ptr(new_mem), lck_out=ptr(new_lck),
        lcv_out=ptr(new_lcv),
        **{k: ptr(v) for k, v in s.items()},
        stream=torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(_cuda.lib().asr_emformer_stack(ctypes.byref(args)),
                "emformer_stack")
    LAUNCHES += 1
    return y, new_mem, new_lck, new_lcv


def emformer_stack(params: dict, x: torch.Tensor, mem: torch.Tensor,
                   lc_k: torch.Tensor, lc_v: torch.Tensor,
                   length: torch.Tensor,
                   reset: Optional[torch.Tensor] = None,
                   advance: Optional[torch.Tensor] = None, *,
                   U: int, R: int, M: int, Lc: int, H: int, use_mem: bool,
                   tanh_on_mem: bool, neg_inf: float, activation: str,
                   cdt: torch.dtype
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
                                    reset, advance, **kw)
    if x.device.type == "cpu":
        return emformer_stack_plain(params, x, mem, lc_k, lc_v, length,
                                    reset.bool(), advance.bool(), **kw)
    raise ValueError(f"emformer_stack: unsupported device {x.device}")
