"""One streaming Emformer layer step: CUDA kernel wrapper + plain version.

Counterpart of asr_streaming_tpu/ops/pallas_emformer.py::fused_emformer_layer
(kernel C).  ``emformer_layer`` has its signature: one layer's params
(``[D, ...]``, weights ``[in, out]``), utt ``[B,U,D]``, rc ``[B,R,D]`` and
mem_row ``[B,1,D]`` in f32, this layer's state mem_state ``[B,M,D]`` and
lc_k/lc_v ``[B,Lc,D]`` in the compute type, the RESET-EFFECTIVE length
``[B]`` and optional reset/advance ``[B]`` masks applied inside the
kernel.  Returns (new_utt, new_rc, new_mem_row, new_mem_state, new_lc_k,
new_lc_v); with M == 0 new_mem_row is None and new_mem_state ``[B,0,D]``.
``quant=True`` runs the five products W8A8, as ``quant`` does there.

The CUDA kernel is one layer of ``csrc/emformer_stack.cu``'s chain, the
same code the stack kernel loops (C entry ``asr_emformer_layer``), so a
stack of these calls gives what the stack kernel gives, bit for bit.  On
a CPU tensor the plain version runs (``emformer_stack._layer_plain``).

``mem_row_from_utt=True`` (with mem_row None) makes the memory row the
mean of the raw utterance, the first layer's, computed by the kernel as
the stack kernel computes it.
"""

from __future__ import annotations

from typing import Optional

import torch

from asr_streaming_tpu_torch.ops import _cuda
from asr_streaming_tpu_torch.ops import emformer_stack as es

# launches of the CUDA kernel (one per layer call that reaches the card)
LAUNCHES = 0


def _layer_weights(p: dict, quant: bool, qweights: Optional[dict]):
    names = es._kernel_quant_names(quant)
    if not names:
        return {}
    if qweights is not None:
        return {n: qweights[n] for n in names}
    return es.quantized_weights(p, names)


def emformer_layer_plain(p, utt, rc, mem_row, mem_state, lc_k, lc_v, length,
                         reset, advance, *, U, R, M, Lc, H, use_mem,
                         tanh_on_mem, neg_inf, activation, cdt, quant=False,
                         qweights=None, mem_row_from_utt=False):
    """The plain PyTorch version of the kernel (any device)."""
    utt, rc = utt.to(torch.float32), rc.to(torch.float32)
    if mem_row_from_utt:
        mem_row = utt.mean(1, keepdim=True)
    qw = _layer_weights(p, quant, qweights)
    out = es._layer_plain(
        utt, rc, mem_row.to(torch.float32) if use_mem else None, mem_state,
        lc_k, lc_v, length, reset, advance, p, U=U, R=R, M=M, Lc=Lc, H=H,
        use_mem=use_mem, tanh_on_mem=tanh_on_mem, neg_inf=neg_inf,
        activation=activation, cdt=cdt,
        qw={n: t[:2] for n, t in qw.items()})
    return out


def _emformer_layer_cuda(p, utt, rc, mem_row, mem_state, lc_k, lc_v, length,
                         reset, advance, *, quant, qweights, kweights,
                         mem_row_from_utt, **kw):
    global LAUNCHES
    _cuda.refuse_grad("emformer_layer", p, utt, rc, mem_row, mem_state,
                      lc_k, lc_v)
    B, U, D = utt.shape
    qw = _layer_weights(p, quant, qweights)
    if kweights is None:
        kweights = es.kernel_weights(p, kw["cdt"], skip=tuple(qw))
    w = {k: v[None] for k, v in kweights.items()}
    qw = {n: (t[0][None], t[1][None], t[2][None]) for n, t in qw.items()}
    if mem_row_from_utt or not kw["use_mem"]:
        memrow = torch.empty((B, D), dtype=torch.float32, device=utt.device)
    else:
        memrow = mem_row.reshape(B, D).to(torch.float32).clone()
    x = torch.cat([utt.to(torch.float32), rc.to(torch.float32)], 1)
    y, nm, nk, nv, hin = es.run_chain(
        "asr_emformer_layer", w, qw, x, length, reset, advance,
        mem_state[None], lc_k[None], lc_v[None], memrow,
        init_memrow=int(mem_row_from_utt and kw["use_mem"]), **kw)
    LAUNCHES += 1
    new_row = memrow.view(B, 1, D) if kw["use_mem"] else None
    return y, hin[:, :kw["R"]], new_row, nm[0], nk[0], nv[0]


def emformer_layer(p: dict, utt: torch.Tensor, rc: torch.Tensor,
                   mem_row: Optional[torch.Tensor], mem_state: torch.Tensor,
                   lc_k: torch.Tensor, lc_v: torch.Tensor,
                   length: torch.Tensor,
                   reset: Optional[torch.Tensor] = None,
                   advance: Optional[torch.Tensor] = None, *,
                   U: int, R: int, M: int, Lc: int, H: int, use_mem: bool,
                   tanh_on_mem: bool, neg_inf: float, activation: str,
                   cdt: torch.dtype, quant: bool = False,
                   qweights: Optional[dict] = None,
                   kweights: Optional[dict] = None,
                   mem_row_from_utt: bool = False):
    """One Emformer layer step (see module doc).  CUDA tensor -> kernel,
    CPU tensor -> plain version.  ``qweights``: this layer's
    {name: (w8, scale, w8t)} from ``emformer_stack.quantized_weights`` of
    the stacked params (else quantised here from ``p``); ``kweights``:
    this layer's slice of ``emformer_stack.kernel_weights`` of the stacked
    params (else made here from ``p``, cached per tensor of ``p``); the
    plain version reads neither."""
    B = utt.shape[0]
    if reset is None:
        reset = torch.zeros(B, dtype=torch.bool, device=utt.device)
    if advance is None:
        advance = torch.ones(B, dtype=torch.bool, device=utt.device)
    if use_mem and mem_row is None and not mem_row_from_utt:
        mem_row = torch.zeros((B, 1, utt.shape[2]), dtype=torch.float32,
                              device=utt.device)
    kw = dict(U=U, R=R, M=M, Lc=Lc, H=H, use_mem=use_mem,
              tanh_on_mem=tanh_on_mem, neg_inf=neg_inf,
              activation=activation, cdt=cdt)
    if use_mem and mem_state.shape[1] == 0:
        raise ValueError("use_mem requires M > 0")
    if utt.device.type == "cuda":
        return _emformer_layer_cuda(p, utt, rc, mem_row, mem_state, lc_k,
                                    lc_v, length, reset, advance,
                                    quant=quant, qweights=qweights,
                                    kweights=kweights,
                                    mem_row_from_utt=mem_row_from_utt, **kw)
    if utt.device.type == "cpu":
        return emformer_layer_plain(p, utt, rc, mem_row, mem_state, lc_k,
                                    lc_v, length, reset.bool(),
                                    advance.bool(), quant=quant,
                                    qweights=qweights,
                                    mem_row_from_utt=mem_row_from_utt, **kw)
    raise ValueError(f"emformer_layer: unsupported device {utt.device}")
