"""The port's Emformer step vs the JAX package.

The port's stack (its kernel's plain version on the CPU) is held against
JAX's Pallas megakernel in interpret mode and against JAX's XLA path; the
port's eager twin is held against the XLA path.  Geometries are those of
tests/test_pallas_emformer.py.  Tolerances are the JAX package's own for
its kernel: 2e-5 in f32, 3e-2 in bf16; lengths exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import emformer as je
from asr_streaming_tpu_torch.models import emformer as te
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy

VI = dict(d_model=64, num_heads=4, ffn_dim=96, num_layers=3,
          segment_length=8, left_context_length=16, right_context_length=2,
          max_memory_size=4)
EN = dict(d_model=64, num_heads=4, ffn_dim=96, num_layers=3,
          segment_length=4, left_context_length=10, right_context_length=1,
          max_memory_size=0)
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(geo, n_steps, B, seed):
    rng = np.random.default_rng(seed)
    T = geo["segment_length"] + geo["right_context_length"]
    xs = rng.standard_normal((n_steps, B, T, geo["d_model"])).astype(
        np.float32)
    resets = rng.random((n_steps, B)) < 0.3
    resets[0] = True
    advances = rng.random((n_steps, B)) < 0.7
    return xs, resets, advances


def _run_jax(cfg, params, xs, resets, advances):
    state = je.init_emformer_state(cfg, xs.shape[1])
    ys, states = [], []
    for x, r, a in zip(xs, resets, advances):
        y, state = je.emformer_stream_step(params, cfg, jnp.asarray(x), state,
                                           reset=jnp.asarray(r),
                                           advance=jnp.asarray(a))
        ys.append(np.asarray(y, np.float32))
        states.append(jax.tree.map(lambda t: np.asarray(t, np.float32),
                                   state))
    return ys, states


def _run_torch(step, cfg, params, xs, resets, advances):
    state = te.init_emformer_state(cfg, xs.shape[1], device="cpu")
    ys, states = [], []
    for x, r, a in zip(xs, resets, advances):
        y, state = step(params, cfg, torch.from_numpy(x), state,
                        reset=torch.from_numpy(r), advance=torch.from_numpy(a))
        ys.append(y.float().numpy())
        states.append(te.EmformerState(*(t.float().numpy() if t.is_floating_point()
                                         else t.numpy() for t in state)))
    return ys, states


def _compare(got, want, tol):
    for step, (yg, yw, sg, sw) in enumerate(zip(got[0], want[0], got[1],
                                                want[1])):
        np.testing.assert_allclose(yg, yw, rtol=tol, atol=tol,
                                   err_msg=f"y step {step}")
        for name in ("mem", "lc_k", "lc_v"):
            np.testing.assert_allclose(
                getattr(sg, name), getattr(sw, name), rtol=tol, atol=tol,
                err_msg=f"{name} step {step}")
        np.testing.assert_array_equal(sg.length, sw.length)


def _setup(geo, dtype, seed=0):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = je.EmformerConfig(**geo, compute_dtype=jdt)
    tcfg = te.EmformerConfig(**geo, compute_dtype=tdt)
    jparams = je.init_emformer_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return jcfg, tcfg, jparams, tparams, tol


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_stack_matches_jax_pallas_interpret(geo, dtype):
    jcfg, tcfg, jparams, tparams, tol = _setup(geo, dtype)
    xs, rs, adv = _inputs(geo, 4, 4, seed=1)
    pallas = dataclasses.replace(jcfg, use_pallas_stack=True,
                                 pallas_stack_tile=2)
    want = _run_jax(pallas, jparams, xs, rs, adv)
    got = _run_torch(te.emformer_stream_step, tcfg, tparams, xs, rs, adv)
    _compare(got, want, tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_stack_matches_jax_xla_path(geo, dtype):
    jcfg, tcfg, jparams, tparams, tol = _setup(geo, dtype, seed=3)
    xs, rs, adv = _inputs(geo, 4, 4, seed=2)
    want = _run_jax(jcfg, jparams, xs, rs, adv)
    got = _run_torch(te.emformer_stream_step, tcfg, tparams, xs, rs, adv)
    _compare(got, want, tol)


@pytest.mark.parametrize("geo", [VI, EN], ids=["vi_mem", "en_nomem"])
def test_eager_twin_matches_jax_xla_path(geo):
    jcfg, tcfg, jparams, tparams, tol = _setup(geo, "f32", seed=5)
    xs, rs, adv = _inputs(geo, 4, 3, seed=6)
    want = _run_jax(jcfg, jparams, xs, rs, adv)
    got = _run_torch(te.emformer_stream_step_eager, tcfg, tparams, xs, rs,
                     adv)
    _compare(got, want, tol)


def test_offline_forward_matches_jax():
    jcfg, tcfg, jparams, tparams, tol = _setup(VI, "f32", seed=7)
    x = np.random.default_rng(8).standard_normal((2, 21, 64)).astype(
        np.float32)
    want, _ = je.emformer_forward(jparams, jcfg, jnp.asarray(x))
    got, _ = te.emformer_forward(tparams, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
