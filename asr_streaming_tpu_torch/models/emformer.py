"""Streaming Emformer encoder in PyTorch.

Counterpart of asr_streaming_tpu/models/emformer.py, same semantics per
streaming step and layer (vi geometry: U=16 utterance frames, R=4 right
context, Lc=32 left context, M=4 memory slots, D=512, H=8, F=2048,
20 layers):

  queries   = [right_context, utterance, summary]           (R+U+1 rows)
  keys/vals = [memory(M), right_context, left_context(Lc), utterance]
  summary   = mean of the layer-norm'd utterance
  mask      : summary row does not attend memory; unfilled memory /
              left-context slots (front) are masked by past-length
              counters m_m = min(M, len/U), m_kv = min(Lc, len)
  state     : memory <- append this layer's *input* memory row;
              left-context K/V <- the utterance keys/values just computed
  next layer's input memory row = tanh(summary attention output)

``emformer_stream_step`` takes the route ``EmformerConfig.route`` names
(each kernel wrapper launches its CUDA kernel for CUDA tensors and runs
its plain version on the CPU):

  "stack" (default): all layers in one call of ``ops/emformer_stack.py``
      (kernel A; the JAX package's ``use_pallas_stack``);
  "layer": one call of ``ops/emformer_layer.py`` per layer (kernel C;
      ``use_pallas_layer``), reset/advance applied inside each call, the
      memory row carried between layers;
  "eager": ``emformer_stream_step_eager``, the eager twin of the JAX
      package's XLA path (``_layer_step`` / ``_finish_layer_step`` with
      global reset/advance selects), line by line — the oracle the
      kernels' plain versions are held against.  With ``fused_attention``
      its attention core is ``ops/emformer_attention.py`` (kernel D;
      ``use_pallas_attention``).

``quant`` is honoured as the JAX package honours it: the stack takes
"int8" and "int8_ffn", the layer route "int8" only, the eager route none.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.ops.emformer_attention import emformer_attention
from asr_streaming_tpu_torch.ops.emformer_layer import emformer_layer
from asr_streaming_tpu_torch.ops.emformer_stack import (
    _kernel_quant_names, emformer_stack, kernel_weights, quantized_weights,
)
from asr_streaming_tpu_torch.parallel.collectives import column_entry, row_exit

ROUTES = ("stack", "layer", "eager")
QUANTS = ("none", "int8", "int8_ffn")


@dataclasses.dataclass(frozen=True)
class EmformerConfig:
    d_model: int = 512
    num_heads: int = 8
    ffn_dim: int = 2048
    num_layers: int = 20
    segment_length: int = 16        # U: utterance frames per step (post-stride)
    left_context_length: int = 32   # Lc
    right_context_length: int = 4   # R
    max_memory_size: int = 4        # M (0 disables memory/summary)
    activation: str = "gelu"
    tanh_on_mem: bool = True
    negative_inf: float = -1e8
    weight_init_scale_strategy: Optional[str] = "depthwise"
    compute_dtype: torch.dtype = torch.float32
    # which kernels run the step: "stack" | "layer" | "eager" (module doc)
    route: str = "stack"
    # eager route: the attention core through kernel D
    fused_attention: bool = False
    # W8A8 products: "none" | "int8" (all five) | "int8_ffn" (the FFN two)
    quant: str = "none"

    def __post_init__(self):
        if self.route not in ROUTES:
            raise ValueError(f"route {self.route!r} not in {ROUTES}")
        if self.quant not in QUANTS:
            raise ValueError(f"quant {self.quant!r} not in {QUANTS}")

    @property
    def use_mem(self) -> bool:
        return self.max_memory_size > 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads


class EmformerState(NamedTuple):
    """Carried per-stream state, fixed shapes, in the compute dtype.

    mem:    [L, B, M, D]  raw memory rows (newest at the end)
    lc_k:   [L, B, Lc, D] projected left-context keys (newest at the end)
    lc_v:   [L, B, Lc, D] projected left-context values
    length: [B] int32     total utterance frames processed so far
    """
    mem: torch.Tensor
    lc_k: torch.Tensor
    lc_v: torch.Tensor
    length: torch.Tensor


def init_emformer_state(cfg: EmformerConfig, batch_size: int,
                        device=None, model_parallel: int = 1
                        ) -> EmformerState:
    """Zero state on ``device`` (default CUDA; raises without it).  Under
    a tensor-parallel split the left-context keys and values hold only the
    rank's heads: ``D / model_parallel`` wide."""
    device = resolve_device(device)
    L, B, D = cfg.num_layers, batch_size, cfg.d_model
    Dk = D // model_parallel
    dt = cfg.compute_dtype
    return EmformerState(
        mem=torch.zeros((L, B, cfg.max_memory_size, D), dtype=dt,
                        device=device),
        lc_k=torch.zeros((L, B, cfg.left_context_length, Dk), dtype=dt,
                         device=device),
        lc_v=torch.zeros((L, B, cfg.left_context_length, Dk), dtype=dt,
                         device=device),
        length=torch.zeros((B,), dtype=torch.int32, device=device),
    )


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0
            - 1.0) * bound


def _xavier_uniform(gen, shape, gain: float = 1.0):
    fan_in, fan_out = shape[0], shape[1]
    return _uniform(gen, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))


def _linear_init(gen, in_dim, out_dim):
    # torch.nn.Linear default init: kaiming-uniform weights, uniform bias.
    bound = 1.0 / math.sqrt(in_dim)
    w = _uniform(gen, (in_dim, out_dim), math.sqrt(3) * bound)
    b = _uniform(gen, (out_dim,), bound)
    return w, b


def init_emformer_params(gen: torch.Generator, cfg: EmformerConfig,
                         device=None) -> dict:
    """Per-layer parameters stacked along dim 0 ([L, ...]), f32, drawn on
    the CPU from ``gen`` (same distributions as the JAX package's init),
    placed on ``device`` (default CUDA; raises without it)."""
    device = resolve_device(device)
    D, Fd, L = cfg.d_model, cfg.ffn_dim, cfg.num_layers
    if cfg.weight_init_scale_strategy == "depthwise":
        gains = [1.0 / math.sqrt(i + 1) for i in range(L)]
    elif cfg.weight_init_scale_strategy == "constant":
        gains = [1.0 / math.sqrt(2)] * L
    else:
        gains = [1.0] * L
    layers = []
    for i in range(L):
        w_kv, b_kv = _linear_init(gen, D, 2 * D)
        w_q, b_q = _linear_init(gen, D, D)
        w_out, b_out = _linear_init(gen, D, D)
        if cfg.weight_init_scale_strategy is not None:
            w_kv = _xavier_uniform(gen, (D, 2 * D), gains[i])
            w_q = _xavier_uniform(gen, (D, D), gains[i])
        w1, b1 = _linear_init(gen, D, Fd)
        w2, b2 = _linear_init(gen, Fd, D)
        layers.append({
            "w_q": w_q, "b_q": b_q, "w_kv": w_kv, "b_kv": b_kv,
            "w_out": w_out, "b_out": b_out,
            "ln_in_scale": torch.ones(D), "ln_in_bias": torch.zeros(D),
            "ff_ln_scale": torch.ones(D), "ff_ln_bias": torch.zeros(D),
            "ff_w1": w1, "ff_b1": b1, "ff_w2": w2, "ff_b2": b2,
            "ln_out_scale": torch.ones(D), "ln_out_bias": torch.zeros(D),
        })
    return {k: torch.stack([layer[k] for layer in layers]).to(device)
            for k in layers[0]}


def emformer_stream_step(
    params: dict, cfg: EmformerConfig, x: torch.Tensor, state: EmformerState,
    reset: Optional[torch.Tensor] = None,
    advance: Optional[torch.Tensor] = None, tp=None,
) -> Tuple[torch.Tensor, EmformerState]:
    """One streaming step over all layers (x [B, U+R, D]: utterance then
    right context), by ``cfg.route`` (module doc).  reset zeroes a slot's
    state before stepping; advance commits the stepped state (else the
    post-reset previous state is kept).  With ``tp``
    (parallel/collectives.py's groups), ``params`` and ``state`` are this
    rank's tensor-parallel shard, which runs on the eager route only.
    Returns (y [B, U, D] f32, new_state)."""
    if cfg.route == "eager":
        return emformer_stream_step_eager(params, cfg, x, state, reset,
                                          advance, tp=tp)
    if tp is not None:
        raise ValueError("a tensor-parallel shard runs on the eager route "
                         f"only, not {cfg.route!r}")
    U, R = cfg.segment_length, cfg.right_context_length
    length = state.length
    if reset is not None:
        length = torch.where(reset, torch.zeros_like(length), length)
    kw = dict(U=U, R=R, M=cfg.max_memory_size, Lc=cfg.left_context_length,
              H=cfg.num_heads, use_mem=cfg.use_mem,
              tanh_on_mem=cfg.tanh_on_mem, neg_inf=cfg.negative_inf,
              activation=cfg.activation, cdt=cfg.compute_dtype)
    if cfg.route == "stack":
        y, mem, lc_k, lc_v = emformer_stack(
            params, x[:, :U + R].to(torch.float32), state.mem, state.lc_k,
            state.lc_v, length, reset, advance, quant=cfg.quant, **kw)
    else:
        y, mem, lc_k, lc_v = _layer_route(params, cfg, x, state, length,
                                          reset, advance, kw)
    new_length = length + U
    if advance is not None:
        new_length = torch.where(advance, new_length, length)
    return y, EmformerState(mem=mem, lc_k=lc_k, lc_v=lc_v,
                            length=new_length.to(torch.int32))


def _layer_route(params, cfg, x, state, length, reset, advance, kw):
    """One kernel-C call per layer (emformer.py:435-464 with
    use_pallas_layer): the masks go into every call, no global selects;
    the first layer's memory row is the mean of the raw utterance."""
    U, R = cfg.segment_length, cfg.right_context_length
    utt, rc = x[:, :U].to(torch.float32), x[:, U:U + R].to(torch.float32)
    quant = cfg.quant == "int8"           # "int8_ffn" quantises nothing here
    qall = quantized_weights(params, _kernel_quant_names(quant))
    # the kernel's weight copies of the stacked params (cached with them)
    kall = (kernel_weights(params, cfg.compute_dtype, skip=tuple(qall))
            if x.device.type == "cuda" else None)
    mem_row = None
    mems, lcks, lcvs = [], [], []
    for l in range(cfg.num_layers):
        p = {k: v[l] for k, v in params.items()}
        utt, rc, mem_row, nm, nk, nv = emformer_layer(
            p, utt, rc, mem_row, state.mem[l], state.lc_k[l], state.lc_v[l],
            length, reset, advance, quant=quant,
            qweights={n: tuple(None if t is None else t[l] for t in q)
                      for n, q in qall.items()},
            kweights=None if kall is None else {n: t[l]
                                                for n, t in kall.items()},
            mem_row_from_utt=l == 0 and cfg.use_mem, **kw)
        mems.append(nm)
        lcks.append(nk)
        lcvs.append(nv)
    return utt, torch.stack(mems), torch.stack(lcks), torch.stack(lcvs)


# ------------------------------------------------ eager twin of the XLA path

def _layer_norm(x, scale, bias, eps=1e-5):
    """In f32 (bf16 is widened; float64 stays float64)."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def _activation(name: str):
    return {"relu": F.relu,
            "gelu": lambda t: F.gelu(t, approximate="tanh"),
            "silu": F.silu}[name]


def _dot(a, b, cdt):
    """cdt @ cdt with f32 accumulation, rounded to cdt once."""
    return torch.matmul(a.to(cdt).float(), b.to(cdt).float()).to(cdt)


def _layer_step(cfg: EmformerConfig, p: dict, utt, rc, mem_row, mem_state,
                lc_k, lc_v, length, tp=None):
    """One Emformer layer, one streaming step (emformer.py:_layer_step).

    ``tp`` (parallel/collectives.py's groups) runs it on a tensor-parallel
    shard: ``p`` holds this rank's columns of ``w_q``/``w_kv`` (the K and
    V of its own heads) and rows of ``w_out``, so the rank attends with
    its ``w_q.shape[-1] / head_dim`` heads and the output projection's
    partial sums reduce over the model group before ``b_out``."""
    B, U, _ = utt.shape
    R = rc.shape[1]
    M, Lc = cfg.max_memory_size, cfg.left_context_length
    Dh = cfg.head_dim
    D = p["w_q"].shape[-1]                # this rank's heads' width
    H = D // Dh
    cdt = cfg.compute_dtype

    ln_rc = _layer_norm(rc, p["ln_in_scale"], p["ln_in_bias"])
    ln_utt = _layer_norm(utt, p["ln_in_scale"], p["ln_in_bias"])
    if cfg.use_mem:
        summary = ln_utt.mean(1, keepdim=True)
        q_in = torch.cat([ln_rc, ln_utt, summary], 1)
    else:
        q_in = torch.cat([ln_rc, ln_utt], 1)
    Q = q_in.shape[1]

    q = _dot(column_entry(q_in, tp), p["w_q"], cdt) + p["b_q"].to(cdt)
    kv_in = torch.cat([mem_state.to(cdt), ln_rc.to(cdt), ln_utt.to(cdt)], 1)
    kv = _dot(column_entry(kv_in, tp), p["w_kv"], cdt) + p["b_kv"].to(cdt)
    k_part, v_part = kv[..., :D], kv[..., D:]
    next_k = k_part[:, M + R:]
    next_v = v_part[:, M + R:]

    full_k = torch.cat([k_part[:, :M + R], lc_k.to(cdt), next_k], 1)
    full_v = torch.cat([v_part[:, :M + R], lc_v.to(cdt), next_v], 1)
    K = full_k.shape[1]

    length = length.to(torch.int64)
    m_kv = torch.clamp(length, max=Lc)
    lc_idx = torch.arange(Lc, device=utt.device)
    valid_lc = lc_idx[None, :] >= (Lc - m_kv)[:, None]
    if cfg.use_mem:
        m_m = torch.clamp(torch.div(length, max(U, 1), rounding_mode="floor"),
                          max=M)
        mem_idx = torch.arange(M, device=utt.device)
        valid_mem = mem_idx[None, :] >= (M - m_m)[:, None]
    else:
        m_m = torch.zeros_like(length)
        valid_mem = torch.ones((B, 0), dtype=torch.bool, device=utt.device)

    if cfg.fused_attention:
        # the core widens cdt to f32 exactly and rounds its f32 result to
        # cdt once: the XLA route's q.astype(f32) -> kernel -> astype(cdt)
        attn = emformer_attention(
            q, full_k, full_v, m_m, m_kv,
            num_heads=H, M=M, R=R, Lc=Lc, U=U, use_mem=cfg.use_mem,
            neg_inf=cfg.negative_inf, out_dtype=cdt)
        out = row_exit(_dot(attn, p["w_out"], cdt), tp) + p["b_out"].to(cdt)
        return _finish_layer_step(cfg, p, out, utt, rc, mem_row, mem_state,
                                  lc_k, lc_v, next_k, next_v, tp)
    valid_keys = torch.cat(
        [valid_mem, torch.ones((B, R), dtype=torch.bool, device=utt.device),
         valid_lc, torch.ones((B, U), dtype=torch.bool, device=utt.device)],
        1)
    mask = valid_keys[:, None, :].expand(B, Q, K).clone()
    if cfg.use_mem and M > 0:
        mask[:, -1, :M] = False

    qh = q.reshape(B, Q, H, Dh).transpose(1, 2)
    kh = full_k.reshape(B, K, H, Dh).transpose(1, 2)
    vh = full_v.reshape(B, K, H, Dh).transpose(1, 2)
    scaling = 1.0 / math.sqrt(Dh)
    logits = torch.matmul((qh * scaling).float(), kh.float().transpose(-1, -2))
    logits = torch.where(mask[:, None], logits,
                         torch.tensor(cfg.negative_inf, dtype=torch.float32,
                                      device=logits.device))
    probs = torch.softmax(logits.float(), -1).to(cdt)
    attn = torch.matmul(probs.float(), vh.float())
    attn = attn.transpose(1, 2).reshape(B, Q, D).to(cdt)
    out = row_exit(_dot(attn, p["w_out"], cdt), tp) + p["b_out"].to(cdt)
    return _finish_layer_step(cfg, p, out, utt, rc, mem_row, mem_state,
                              lc_k, lc_v, next_k, next_v, tp)


def _finish_layer_step(cfg: EmformerConfig, p: dict, out, utt, rc, mem_row,
                       mem_state, lc_k, lc_v, next_k, next_v, tp=None):
    """Post-attention: mem output transform, residual FFN, state update
    (emformer.py:_finish_layer_step).  ``out`` is whole (reduced); under
    ``tp`` the FFN's ``ff_w1`` columns and ``ff_w2`` rows are the rank's,
    and ``ff_b2`` is added once after the reduction."""
    R, U = rc.shape[1], utt.shape[1]
    Lc = cfg.left_context_length
    cdt = cfg.compute_dtype

    rc_utt_out = out[:, :R + U].float()
    if cfg.use_mem:
        mem_out = out[:, R + U:].float()
        new_mem_row = (torch.tanh(mem_out) if cfg.tanh_on_mem
                       else torch.clamp(mem_out, -10.0, 10.0))
    else:
        new_mem_row = None

    residual = rc_utt_out + torch.cat([rc, utt], 1)
    ff = _layer_norm(residual, p["ff_ln_scale"], p["ff_ln_bias"])
    ff = _activation(cfg.activation)(
        _dot(column_entry(ff, tp), p["ff_w1"], cdt) + p["ff_b1"].to(cdt))
    ff = (row_exit(_dot(ff, p["ff_w2"], cdt), tp)
          + p["ff_b2"].to(cdt)).float()
    result = _layer_norm(residual + ff, p["ln_out_scale"], p["ln_out_bias"])
    new_rc, new_utt = result[:, :R], result[:, R:]

    if cfg.use_mem:
        new_mem_state = torch.cat(
            [mem_state[:, 1:], mem_row.to(mem_state.dtype)], 1)
    else:
        new_mem_state = mem_state
    new_lc_k = torch.cat([lc_k, next_k.to(lc_k.dtype)], 1)[:, -Lc:]
    new_lc_v = torch.cat([lc_v, next_v.to(lc_v.dtype)], 1)[:, -Lc:]
    return new_utt, new_rc, new_mem_row, new_mem_state, new_lc_k, new_lc_v


def emformer_stream_step_eager(
    params: dict, cfg: EmformerConfig, x: torch.Tensor, state: EmformerState,
    reset: Optional[torch.Tensor] = None,
    advance: Optional[torch.Tensor] = None, tp=None,
) -> Tuple[torch.Tensor, EmformerState]:
    """emformer_stream_step on the XLA path's spelling: global pre-select
    of the reset state, a Python loop over layers, global post-select.
    ``cfg.quant`` is ignored here, as on the XLA path.  ``tp``: a
    tensor-parallel shard of ``params`` and ``state`` (``_layer_step``)."""
    U = cfg.segment_length
    R = cfg.right_context_length
    utt, rc = x[:, :U].float(), x[:, U:U + R].float()
    length = state.length
    if reset is not None:
        length = torch.where(reset, torch.zeros_like(length), length)
        m4 = reset.view(1, -1, 1, 1)
        state = EmformerState(
            mem=torch.where(m4, torch.zeros_like(state.mem), state.mem),
            lc_k=torch.where(m4, torch.zeros_like(state.lc_k), state.lc_k),
            lc_v=torch.where(m4, torch.zeros_like(state.lc_v), state.lc_v),
            length=length)

    mem_row = utt.mean(1, keepdim=True) if cfg.use_mem else None
    mems, lcks, lcvs = [], [], []
    for l in range(cfg.num_layers):
        p = {k: v[l] for k, v in params.items()}
        utt, rc, mem_row, nm, nk, nv = _layer_step(
            cfg, p, utt, rc, mem_row, state.mem[l], state.lc_k[l],
            state.lc_v[l], length, tp)
        mems.append(nm)
        lcks.append(nk)
        lcvs.append(nv)
    mem, lc_k, lc_v = torch.stack(mems), torch.stack(lcks), torch.stack(lcvs)

    new_length = length + U
    if advance is not None:
        new_length = torch.where(advance, new_length, length)
        m4 = advance.view(1, -1, 1, 1)
        mem = torch.where(m4, mem, state.mem)
        lc_k = torch.where(m4, lc_k, state.lc_k)
        lc_v = torch.where(m4, lc_v, state.lc_v)
    return utt, EmformerState(mem=mem, lc_k=lc_k, lc_v=lc_v,
                              length=new_length.to(torch.int32))


def emformer_forward(params: dict, cfg: EmformerConfig, x: torch.Tensor,
                     x_lens: Optional[torch.Tensor] = None, tp=None):
    """Offline forward: the streaming step scanned over chunks (right
    context for chunk i is the first R frames of chunk i+1, zero-padded
    at the end).  x [B, T, D] -> (y [B, T_padded, D], x_lens).  With
    ``tp``, ``params`` is this rank's tensor-parallel shard
    (``emformer_stream_step``)."""
    B, T, D = x.shape
    U, R = cfg.segment_length, cfg.right_context_length
    n_chunks = -(-T // U)
    T_pad = n_chunks * U
    x = F.pad(x, (0, 0, 0, T_pad - T + R))
    mp = 1 if tp is None else tp.model_parallel
    state = init_emformer_state(cfg, B, device=x.device, model_parallel=mp)
    ys = []
    for i in range(n_chunks):
        chunk = x[:, i * U:i * U + U + R]
        y, state = emformer_stream_step(params, cfg, chunk, state, tp=tp)
        ys.append(y)
    return torch.cat(ys, 1), x_lens
