"""Plain reference of the streaming Emformer step, in float32.

A frozen copy of the port's eager route (``models/emformer.py``:
``emformer_stream_step_eager``, ``_layer_step``, ``_finish_layer_step``)
at float32, with the attention written out as masked softmax.  The
geometry comes from the configuration file (``d_model``, ``num_heads``,
``segment_length`` U, ``right_context_length`` R, ``left_context_length``
Lc, ``max_memory_size`` M); the weights are the port's stacked tree
([L, ...] per leaf).  State: mem [L, B, M, D], lc_k / lc_v [L, B, Lc, D],
length [B] (frames processed since the last reset).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e8


def layer_norm(x, scale, bias, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def zero_state(em: dict, batch: int, device) -> dict:
    L, D = em["num_layers"], em["d_model"]
    z = dict(device=device, dtype=torch.float32)
    return {"mem": torch.zeros((L, batch, em["max_memory_size"], D), **z),
            "lc_k": torch.zeros((L, batch, em["left_context_length"], D), **z),
            "lc_v": torch.zeros((L, batch, em["left_context_length"], D), **z),
            "length": torch.zeros((batch,), dtype=torch.int64, device=device)}


def _layer(em, p, utt, rc, mem_row, mem_state, lc_k, lc_v, length):
    B, U, D = utt.shape
    R = rc.shape[1]
    M, Lc, H = em["max_memory_size"], em["left_context_length"], em["num_heads"]
    Dh = D // H
    ln_rc = layer_norm(rc, p["ln_in_scale"], p["ln_in_bias"])
    ln_utt = layer_norm(utt, p["ln_in_scale"], p["ln_in_bias"])
    q_in = [ln_rc, ln_utt] + ([ln_utt.mean(1, keepdim=True)] if M else [])
    q_in = torch.cat(q_in, 1)
    Q = q_in.shape[1]
    q = q_in @ p["w_q"] + p["b_q"]
    kv = torch.cat([mem_state, ln_rc, ln_utt], 1) @ p["w_kv"] + p["b_kv"]
    k_part, v_part = kv[..., :D], kv[..., D:]
    next_k, next_v = k_part[:, M + R:], v_part[:, M + R:]
    full_k = torch.cat([k_part[:, :M + R], lc_k, next_k], 1)
    full_v = torch.cat([v_part[:, :M + R], lc_v, next_v], 1)
    K = full_k.shape[1]

    m_kv = torch.clamp(length, max=Lc)
    valid_lc = torch.arange(Lc, device=utt.device)[None] >= (Lc - m_kv)[:, None]
    if M:
        m_m = torch.clamp(length // U, max=M)
        valid_mem = torch.arange(M, device=utt.device)[None] >= (M - m_m)[:, None]
    else:
        valid_mem = torch.ones((B, 0), dtype=torch.bool, device=utt.device)
    ones = lambda n: torch.ones((B, n), dtype=torch.bool, device=utt.device)
    valid = torch.cat([valid_mem, ones(R), valid_lc, ones(U)], 1)
    mask = valid[:, None, :].expand(B, Q, K).clone()
    if M:
        mask[:, -1, :M] = False        # the summary row skips the memory
    qh = q.reshape(B, Q, H, Dh).transpose(1, 2)
    kh = full_k.reshape(B, K, H, Dh).transpose(1, 2)
    vh = full_v.reshape(B, K, H, Dh).transpose(1, 2)
    logits = (qh / math.sqrt(Dh)) @ kh.transpose(-1, -2)
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    attn = (torch.softmax(logits, -1) @ vh).transpose(1, 2).reshape(B, Q, D)
    out = attn @ p["w_out"] + p["b_out"]

    new_mem_row = torch.tanh(out[:, R + U:]) if M else None
    residual = out[:, :R + U] + torch.cat([rc, utt], 1)
    ff = layer_norm(residual, p["ff_ln_scale"], p["ff_ln_bias"])
    ff = F.gelu(ff @ p["ff_w1"] + p["ff_b1"], approximate="tanh")
    ff = ff @ p["ff_w2"] + p["ff_b2"]
    result = layer_norm(residual + ff, p["ln_out_scale"], p["ln_out_bias"])
    new_mem = (torch.cat([mem_state[:, 1:], mem_row], 1) if M else mem_state)
    new_lc_k = torch.cat([lc_k, next_k], 1)[:, -Lc:]
    new_lc_v = torch.cat([lc_v, next_v], 1)[:, -Lc:]
    return result[:, R:], result[:, :R], new_mem_row, new_mem, new_lc_k, new_lc_v


def step(params: dict, em: dict, x: torch.Tensor, state: dict, reset, advance):
    """One streaming step over all layers.  x [B, U + R, D] (utterance,
    then right context); ``reset`` zeroes a slot's state first;
    ``advance`` commits the new state (else the post-reset state stays).
    Returns (y [B, U, D], new state)."""
    U, R = em["segment_length"], em["right_context_length"]
    utt, rc = x[:, :U], x[:, U:U + R]
    m4 = reset.view(1, -1, 1, 1)
    st = {k: torch.where(m4, torch.zeros_like(state[k]), state[k])
          for k in ("mem", "lc_k", "lc_v")}
    length = torch.where(reset, torch.zeros_like(state["length"]),
                         state["length"])
    mem_row = utt.mean(1, keepdim=True) if em["max_memory_size"] else None
    mems, lcks, lcvs = [], [], []
    for l in range(em["num_layers"]):
        p = {k: v[l] for k, v in params.items()}
        utt, rc, mem_row, nm, nk, nv = _layer(
            em, p, utt, rc, mem_row, st["mem"][l], st["lc_k"][l],
            st["lc_v"][l], length)
        mems.append(nm)
        lcks.append(nk)
        lcvs.append(nv)
    a4 = advance.view(1, -1, 1, 1)
    new = {"mem": torch.where(a4, torch.stack(mems), st["mem"]),
           "lc_k": torch.where(a4, torch.stack(lcks), st["lc_k"]),
           "lc_v": torch.where(a4, torch.stack(lcvs), st["lc_v"]),
           "length": torch.where(advance, length + U, length)}
    return utt, new


def time_reduction(x, stride):
    b, t, d = x.shape
    pad = (stride - t % stride) % stride
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    return x.reshape(b, (t + pad) // stride, d * stride)
