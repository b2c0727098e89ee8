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

``attention_plan`` computes, as the CUDA core does on the host, how the
kernels of D and of A's attention split their work: units (a slot's
heads, at small B a share of their query rows), warps, stages and shared
memory; ``kernel_attention_plan`` reads the library's own plan with its
registers and resident blocks (card only).
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


# The launch plan (csrc/emformer_attention_core.cuh, attn_core::make_plan
# and ::layout, computed on the host): the same rules, so that the tests
# can check here that every (slot, head, query row) is covered once and
# that a block's shared memory fits.
PLAN_FIELDS = ("mma", "hpu", "wph", "rpw", "qb", "splits", "groups",
               "warps", "units", "stages", "stage_bytes", "smem")
MAX_WARPS, MAX_GROUP_WARPS, MAX_SMEM = 16, 8, 232448
FMA_ROWS, ZERO_BYTES, MAX_PLANES = 6, 128, 3
H100_SMS = 132


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _layout(p: dict, segments) -> dict:
    """A stage: a region a plane (its q box, each segment's boxes and a
    zero line); then the FMA path's per-warp rows, the barriers and a tag
    a stage."""
    off = _round_up(p["hpu"] * p["qb"] * p["line"], 1024)
    for rows, joint in segments:
        if rows:
            one = p["hpu"] * rows * p["line"]
            off += (_round_up(2 * one, 1024) if joint
                    else 2 * _round_up(one, 1024))
    p["stage_bytes"] = p["planes"] * _round_up(off + ZERO_BYTES, 1024)
    rows = 1 if p["rpw"] == 1 else FMA_ROWS       # the kernel's rows a warp
    warp_bytes = (0 if p["mma"]
                  else _round_up(rows * (p["Dh"] + p["kp"]) * 4, 16))
    p["smem"] = (1024 + p["stages"] * p["stage_bytes"]
                 + p["warps"] * warp_bytes + 20 * p["stages"])
    return p


def attention_plan(B: int, H: int, Q: int, Dh: int, itemsize: int, segments,
                   mma: bool = False, sms: int = H100_SMS) -> dict:
    """The plan of one launch: ``segments`` are the key segments in order,
    (rows, joint: k and v in one box) each; ``itemsize`` the inputs' bytes
    a value.
    Tensor cores: a warp a 16-row tile, up to 8 warps a group.  FMA: at
    large B (B * H >= sms) up to 6 rows a warp, ceil(Q / 6) warps a head,
    up to 4 warps a group; at small B one row a warp, a unit the largest
    divisor of Q up to 8 rows of one head.  Then the heads a unit and the
    groups a block (stages = groups + 1, up to 16 warps) that give a block
    the most warps that fit, more heads first; one group where the units
    are no more than the SMs.  Raises if nothing fits."""
    K = sum(rows for rows, _ in segments)
    line = 128
    while (Dh * itemsize) % line:
        line //= 2
    p = dict(mma=int(mma), line=line, planes=Dh * itemsize // line, Dh=Dh,
             kp=_round_up(K, 16 if mma else 4))
    if p["planes"] > MAX_PLANES:
        raise ValueError(f"attention plan: head width {Dh} is {p['planes']} "
                         f"lines of {line} bytes (at most {MAX_PLANES})")
    if mma:
        wph = (Q + 15) // 16
        p.update(wph=wph, rpw=16, qb=16 * wph, splits=1)
        max_gw = MAX_GROUP_WARPS
    elif B * H < sms:
        wph = max(d for d in range(1, MAX_GROUP_WARPS + 1) if Q % d == 0)
        p.update(rpw=1, wph=wph, qb=wph, splits=Q // wph)
        max_gw = wph
    else:
        rpw = min(Q, FMA_ROWS)
        wph = -(-Q // rpw)
        p.update(rpw=rpw, wph=wph, qb=Q, splits=1)
        max_gw = max(wph, 4)
    best = None
    for hpu in range(H, 0, -1):
        gw = hpu * p["wph"]
        if H % hpu or gw > max_gw:
            continue
        units = B * (H // hpu) * p["splits"]
        for groups in range(1 if units <= sms else MAX_WARPS // gw, 0, -1):
            t = _layout(dict(p, hpu=hpu, groups=groups, warps=groups * gw,
                             stages=groups + 1, units=units), segments)
            if t["smem"] <= MAX_SMEM:
                if best is None or t["warps"] > best["warps"]:
                    best = t
                break
    if best is None:
        raise ValueError(f"attention plan: nothing fits (B={B}, H={H}, "
                         f"Q={Q}, K={K}, Dh={Dh})")
    return {k: best[k] for k in PLAN_FIELDS}


def stack_attention_plan(B, H, D, U, R, M, Lc, use_mem, itemsize,
                         sms=H100_SMS) -> dict:
    """A's attention launch: tensor cores in bf16 (itemsize 2), FMA in
    f32; keys from the kv rows (memory + right context, then the
    utterance, k and v a box) and the left context (a box each)."""
    return attention_plan(B, H, R + U + int(use_mem), D // H, itemsize,
                          [(M + R, True), (Lc, False), (U, True)],
                          mma=itemsize == 2, sms=sms)


def plain_attention_plan(B, Q, K, D, H, itemsize, sms=H100_SMS) -> dict:
    """Kernel D's launch (FMA, k and v a box each)."""
    return attention_plan(B, H, Q, D // H, itemsize, [(K, False)], sms=sms)


def plan_rows(plan: dict, B: int, H: int, Q: int):
    """Every (slot, head, query row) the plan's warps take, as the kernels
    walk it: unit u = (b * (H / hpu) + hg) * splits + split, taken by one
    group, whose warp w takes head hg * hpu + w // wph and, on the tensor
    cores, rows of the 16-row tile w % wph, in the FMA path rows split * qb
    + (w % wph) * rpw, + rpw (below Q).  Yields (unit, warp, b, h, rows)."""
    hg_n = H // plan["hpu"]
    for u in range(plan["units"]):
        split, hg = u % plan["splits"], (u // plan["splits"]) % hg_n
        b = u // plan["splits"] // hg_n
        for w in range(plan["warps"] // plan["groups"]):
            h = hg * plan["hpu"] + w // plan["wph"]
            lo = (16 * (w % plan["wph"]) if plan["mma"] else
                  split * plan["qb"] + (w % plan["wph"]) * plan["rpw"])
            yield u, w, b, h, range(lo, min(Q, lo + plan["rpw"]))


def kernel_attention_plan(kind: str, *, B, Q, K, D, H, M, R, Lc, use_mem,
                          dtype=torch.float32, out_dtype=None) -> dict:
    """The library's plan for D's launch (``kind`` "D") or A's attention
    (``kind`` "A", dtype bf16 or f32) at a geometry, with the kernel's
    registers a thread, the blocks resident an SM and the persistent grid
    (card only)."""
    import ctypes
    out = (ctypes.c_int * 15)()
    bf = int(dtype == torch.bfloat16)
    if kind == "A":
        rc = _cuda.lib().asr_stack_attention_plan(
            B, H, D, K - M - R - Lc, R, M, Lc, int(use_mem), bf, out)
    else:
        rc = _cuda.lib().asr_emformer_attention_plan(
            B, Q, K, D, H, M, R, Lc, int(use_mem), bf,
            int((out_dtype or torch.float32) == torch.bfloat16), out)
    _cuda.check(rc, f"{kind} attention plan")
    return dict(zip(PLAN_FIELDS + ("grid", "registers", "resident"), out))


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
