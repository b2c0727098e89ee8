"""Masked Emformer attention core: CUDA kernel wrapper + plain version.

Counterpart of asr_streaming_tpu/ops/pallas_attention.py::
fused_emformer_attention (kernel D).  q ``[B,Q,D]``, k/v ``[B,K,D]`` in
f32 (keys ``[memory, right context, left context, utterance]``) and the
fill counts m_m/m_kv ``[B]`` -> ``[B,Q,D]`` f32, before the output
projection.  The first ``M - m_m`` memory columns and the first
``Lc - m_kv`` left-context columns are invalid; with memory the summary
query (the last row) sees no memory column.  The softmax and both
products stay in f32: nothing is rounded to a compute type here (the
caller casts the result).

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
                             use_mem=True, neg_inf=-1e8):
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
    return torch.matmul(probs, vh).transpose(1, 2).reshape(B, Q, D)


def _emformer_attention_cuda(q, k, v, m_m, m_kv, *, num_heads, M, R, Lc, U,
                             use_mem, neg_inf):
    global LAUNCHES
    dev = q.device
    B, Q, D = q.shape
    K = k.shape[1]
    if D % num_heads:
        raise ValueError(f"emformer_attention: D={D}, H={num_heads}")
    if K != M + R + Lc + U or Q != R + U + (1 if use_mem else 0):
        raise ValueError(f"emformer_attention: Q={Q}, K={K} do not fit "
                         f"M={M}, R={R}, Lc={Lc}, U={U}, use_mem={use_mem}")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, K, D) or t.device != dev:
            raise ValueError(f"{name}: {tuple(t.shape)} on {t.device}")
    q, k, v = (t.to(torch.float32).contiguous() for t in (q, k, v))
    m_m = m_m.to(device=dev, dtype=torch.int32).contiguous()
    m_kv = m_kv.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty((B, Q, D), dtype=torch.float32, device=dev)
    _cuda.check(_cuda.lib().asr_emformer_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), m_m.data_ptr(),
        m_kv.data_ptr(), out.data_ptr(), B, Q, K, D, num_heads, M, R, Lc,
        int(use_mem), float(neg_inf),
        torch.cuda.current_stream(dev).cuda_stream), "emformer_attention")
    LAUNCHES += 1
    return out


def emformer_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       m_m: torch.Tensor, m_kv: torch.Tensor, *,
                       num_heads: int, M: int, R: int, Lc: int, U: int,
                       use_mem: bool = True, neg_inf: float = -1e8
                       ) -> torch.Tensor:
    """Masked attention core (see module doc).  CUDA tensor -> kernel, CPU
    tensor -> plain version."""
    kw = dict(num_heads=num_heads, M=M, R=R, Lc=Lc, U=U, use_mem=use_mem,
              neg_inf=neg_inf)
    if q.device.type == "cuda":
        return _emformer_attention_cuda(q, k, v, m_m, m_kv, **kw)
    if q.device.type == "cpu":
        return emformer_attention_plain(q, k, v, m_m, m_kv, **kw)
    raise ValueError(f"emformer_attention: unsupported device {q.device}")
