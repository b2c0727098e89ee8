"""Masked Emformer attention core: CUDA kernel wrapper + plain version.

Counterpart of asr_streaming_tpu/ops/pallas_attention.py::
fused_emformer_attention (kernel D).  q ``[B,Q,D]``, k/v ``[B,K,D]``
(keys ``[memory, right context, left context, utterance]``) and the fill
counts m_m/m_kv ``[B]`` -> ``[B,Q,D]``, before the output projection.
The first ``M - m_m`` memory columns and the first ``Lc - m_kv``
left-context columns are invalid; with memory the summary query (the last
row) sees no memory column.  The softmax and both products stay in f32:
nothing is rounded in between.  q, k and v come as f32 or bf16 (one
dtype; bf16 is widened exactly), and the result goes out as ``out_dtype``
(f32 by default, the Pallas kernel's; bf16 rounds the f32 result once),
so bf16 in and out is the same function as widening, the f32 core, and
casting.

On a CUDA tensor it launches ``csrc/emformer_attention.cu``; on a CPU
tensor it runs ``emformer_attention_plain``.  Nothing else.
"""

from __future__ import annotations

import math

import torch

from asr_streaming_tpu_torch.ops import _cuda

# launches of the CUDA kernel (one per call that reaches the card)
LAUNCHES = 0


def attention_mask(m_m, m_kv, *, Q, K, M, R, Lc, use_mem):
    """[B, Q, K] bool validity (pallas_attention.py:_attention_kernel)."""
    col = torch.arange(K, device=m_kv.device).view(1, K)
    m_kv = m_kv.to(torch.int64).view(-1, 1)
    valid = ~((col >= M + R) & (col < M + R + (Lc - m_kv)))
    if use_mem:
        m_m = m_m.to(torch.int64).view(-1, 1)
        valid = valid & ~((col < M) & (col < (M - m_m)))
    mask = valid[:, None, :].expand(-1, Q, K).clone()
    if use_mem:
        mask[:, Q - 1, :M] = False                 # summary row: no memory
    return mask


def emformer_attention_plain(q, k, v, m_m, m_kv, *, num_heads, M, R, Lc, U,
                             use_mem=True, neg_inf=-1e8,
                             out_dtype=torch.float32):
    """The plain PyTorch version of the kernel (any device), in f32."""
    B, Q, D = q.shape
    K = k.shape[1]
    H, Dh = num_heads, D // num_heads
    mask = attention_mask(m_m, m_kv, Q=Q, K=K, M=M, R=R, Lc=Lc,
                          use_mem=use_mem)
    qh = (q.float() * (1.0 / math.sqrt(Dh))).view(B, Q, H, Dh).transpose(1, 2)
    kh = k.float().view(B, K, H, Dh).transpose(1, 2)
    vh = v.float().view(B, K, H, Dh).transpose(1, 2)
    logits = torch.matmul(qh, kh.transpose(-1, -2))
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(neg_inf, dtype=torch.float32,
                                      device=q.device))
    probs = torch.softmax(logits, -1)
    out = torch.matmul(probs, vh).transpose(1, 2).reshape(B, Q, D)
    return out.to(out_dtype)


_DTYPES = (torch.float32, torch.bfloat16)

# The geometry of the attention core the kernels share
# (csrc/emformer_attention_core.cuh, attn_core::supports and
# ::supports_mma): at most 32 query rows and 128 keys; a head width Dh that
# is 1, 2, 4, 8 or 16 16-byte vectors (f32: 4 to 64, bf16: 8 to 128); and
# for the tensor-core products of kernel A in bf16, a multiple of 16 up to
# 64.  Every configuration of the repository fits (VI: Q = 21, K = 56; EN:
# Q = 5, K = 35; Dh = 64 or 16).
MAX_QUERIES, MAX_KEYS = 32, 128


def check_geometry(Q: int, K: int, Dh: int, dtype: torch.dtype,
                   mma: bool = False, what: str = "emformer attention"):
    """Raise ValueError unless the attention core takes Q query rows, K
    keys and head width Dh in ``dtype`` (``mma``: A's bf16 tensor-core
    products).  The CUDA entries refuse the same shapes."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    ok = Dh % vec == 0 and Dh // vec in (1, 2, 4, 8, 16)
    if mma:
        ok = ok and Dh % 16 == 0 and Dh <= 64
    if not (1 <= Q <= MAX_QUERIES and 1 <= K <= MAX_KEYS and ok):
        heads = ("a multiple of 16 up to 64" if mma else
                 f"{vec} x 1, 2, 4, 8 or 16")
        raise ValueError(
            f"{what}: Q={Q} query rows, K={K} keys, head width {Dh} in "
            f"{dtype} are outside the CUDA kernel's geometry (Q <= "
            f"{MAX_QUERIES}, K <= {MAX_KEYS}, head width {heads})")


def _emformer_attention_cuda(q, k, v, m_m, m_kv, *, num_heads, M, R, Lc, U,
                             use_mem, neg_inf, out_dtype):
    global LAUNCHES
    _cuda.refuse_grad("emformer_attention", q, k, v)
    dev = q.device
    B, Q, D = q.shape
    K = k.shape[1]
    if D % num_heads:
        raise ValueError(f"emformer_attention: D={D}, H={num_heads}")
    if q.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise ValueError(f"emformer_attention: q {q.dtype}, out {out_dtype} "
                         f"(f32 or bf16)")
    if K != M + R + Lc + U or Q != R + U + (1 if use_mem else 0):
        raise ValueError(f"emformer_attention: Q={Q}, K={K} do not fit "
                         f"M={M}, R={R}, Lc={Lc}, U={U}, use_mem={use_mem}")
    check_geometry(Q, K, D // num_heads, q.dtype, what="emformer_attention")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, K, D) or t.device != dev or \
                t.dtype != q.dtype:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, q {q.dtype}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    m_m = m_m.to(device=dev, dtype=torch.int32).contiguous()
    m_kv = m_kv.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, Q, D), dtype=out_dtype, device=dev)
    _cuda.launch(
        dev, "asr_emformer_attention", "emformer_attention",
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m_m.data_ptr(),
        m_kv.data_ptr(), out.data_ptr(), B, Q, K, D, num_heads, M, R, Lc,
        int(use_mem), float(neg_inf), int(q.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream)
    LAUNCHES += 1
    return out


def emformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       m_m: torch.Tensor, m_kv: torch.Tensor, *,
                       num_heads: int, M: int, R: int, Lc: int, U: int,
                       use_mem: bool = True, neg_inf: float = -1e8,
                       out_dtype: torch.dtype = torch.float32
                       ) -> torch.Tensor:
    """Masked attention core (see module doc).  CUDA tensor -> kernel, CPU
    tensor -> plain version."""
    kw = dict(num_heads=num_heads, M=M, R=R, Lc=Lc, U=U, use_mem=use_mem,
              neg_inf=neg_inf, out_dtype=out_dtype)
    if q.device.type == "cuda":
        return _emformer_attention_cuda(q, k, v, m_m, m_kv, **kw)
    if q.device.type == "cpu":
        return emformer_attention_plain(q, k, v, m_m, m_kv, **kw)
    raise ValueError(f"emformer_attention: unsupported device {q.device}")
