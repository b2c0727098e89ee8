"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked ``gpu``; each test skips inside itself without a CUDA device.
Imports neither jax nor the JAX package, so on a machine with only
PyTorch it runs as
``python -m pytest --noconftest tests/test_torch_kernels_gpu.py -m gpu``.
Tolerances: f32 1e-4 (summation order only), bf16 3e-2 (the JAX
package's bf16 tolerance for its own kernel), the append exact.
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


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
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
def test_emission_append_kernel_matches_plain_exactly():
    dev = _cuda()
    rng = np.random.default_rng(3)
    B, max_t, U, V = 16, 128, 16, 803
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
