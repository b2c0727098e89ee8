"""Helpers shared by the port's parity tests
(tests/test_torch_train_*.py, tests/test_torch_offline_models.py, and the
scheduler and server tests that run the JAX scheduler as their oracle):
JAX trees carried into torch, JAX-shaped trees of seeded numpy values,
tree comparisons by relative L2, synthetic wav manifests, and the JAX
scheduler made to wait for each of its steps."""

import contextlib
import json
import wave as wave_mod

import numpy as np
import torch

import jax
import pytest

from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread for a module's tests (imported by a test
    module, it applies there).  The tier-1 run puts six workers on the
    machine's cores, each torch process on as many threads as cores:
    oversubscribed, the convolution-heavy GAN tests ran 10-40x slower
    than alone, while alone one thread costs them nothing (the JAX side's
    compiles dominate)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def synchronous(jsched):
    """The JAX scheduler with each step finished before its tick goes on.

    On the CPU, ``jnp.asarray`` of a host array may alias its memory
    instead of copying it (it does when the buffer is 64-byte aligned),
    and the JAX scheduler clears its host reset flags right after
    dispatching a step that reads them; when the step runs late (a loaded
    machine) it sees them cleared and a new stream keeps the state of its
    slot's previous one (ROADMAP fault 13), or, in the English beam mode,
    every beam stays dead and no event comes.  Waiting for each step is
    the reference's intended result, so the oracle is made steady this
    way, on this instance only."""
    run_step = jsched._run_step
    jsched._run_step = lambda *a: jax.block_until_ready(run_step(*a))
    return jsched


def to_torch(jtree, device="cpu"):
    """A JAX parameter tree (dicts and lists of arrays) as f32 tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device)


def numpy_tree(init_fn, seed: int):
    """The tree ``init_fn(key)`` returns (its structure, shapes and
    dtypes from ``jax.eval_shape``, so no jax.random op compiles) filled
    with seeded numpy values: weights normal / sqrt(fan-in), ``*var``
    leaves positive, ``*scale`` leaves near 1, every other vector (biases,
    running means, ``u``/``v``) normal * 0.1."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        z = rng.standard_normal(s.shape)
        if name.endswith("var"):
            z = 1.0 + 0.3 * np.abs(z)
        elif name.endswith("scale"):
            z = 1.0 + 0.1 * z
        elif len(s.shape) <= 1 or name.endswith(("mean", "bias")):
            z = 0.1 * z
        else:
            fan = s.shape[0] if len(s.shape) == 2 else int(
                np.prod(s.shape[1:]))
            z = z / np.sqrt(fan)
        return jax.numpy.asarray(z.astype(s.dtype))

    shapes = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(fill, shapes)


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64``."""
    float32 = jax.numpy.float64

    def __getattr__(self, name):
        return getattr(jax.numpy, name)


@contextlib.contextmanager
def jax_float64(*modules):
    """Run JAX in float64 (``jax.enable_x64``), with the ``jnp.float32``
    that ``modules`` name (constants, casts, ``preferred_element_type``)
    read as float64: the JAX functions' own code, without its f32
    roundings.  Arrays for it are made inside the context."""
    saved = [m.jnp for m in modules]
    try:
        for m in modules:
            m.jnp = _Wide()
        with jax.enable_x64(True):
            yield
    finally:
        for m, j in zip(modules, saved):
            m.jnp = j


def zero_grad_leaves(tree):
    """Paths of ``tree`` whose gradient is 0 in exact arithmetic in the
    Squeezeformer models: the key and positional biases (``attn/bk``,
    ``attn/bp``) shift a query's scores alike and the softmax removes
    them; a conv bias right before a BatchNorm on the batch's statistics
    (``conv/dw_b``, ``subsampling/c1_b``, ``dur1/b``, ``dur2/b``) is
    removed by the mean."""
    ends = ("/attn/bk", "/attn/bp", "/conv/dw_b", "/subsampling/c1_b",
            "/dur1/b", "/dur2/b")
    return tuple(p for p, _, _ in pairs(tree, tree) if p.endswith(ends))


def pairs(got, want, path=""):
    """(path, got leaf, want leaf) over two trees of one structure."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            yield from pairs(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            yield from pairs(g, w, f"{path}/{i}")
    else:
        g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
            else np.asarray(got)
        yield path, g, np.asarray(want)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def assert_trees_rel_l2(got, want, tol, zero_in_exact_arithmetic=()):
    """Every leaf within ``tol`` relative L2 of the reference; a leaf the
    reference holds at zero must be zero.  Leaves named in
    ``zero_in_exact_arithmetic`` (paths whose true value is 0, so both
    sides hold rounding noise) must be below ``tol`` times the largest
    reference leaf's peak instead."""
    bad = []
    scale = max(float(np.abs(w).max()) for _, _, w in pairs(got, want))
    for path, g, w in pairs(got, want):
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if path in zero_in_exact_arithmetic:
            if max(np.abs(g).max(), np.abs(w).max()) > tol * scale:
                bad.append((path, "not at the rounding floor"))
            continue
        if not np.any(w):
            if np.any(g):
                bad.append((path, "nonzero where the reference is 0"))
            continue
        err = rel_l2(g, w)
        if not err <= tol:
            bad.append((path, err))
    assert not bad, bad


def write_wav(path, wave: np.ndarray, sr: int = 16000):
    pcm = np.clip(np.asarray(wave) * 32767, -32768, 32767).astype(np.int16)
    with wave_mod.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def noise_manifest(directory, n=4, seconds=1.0, step=0.3, text="a b a",
                   extra=None):
    """``n`` wavs of seeded noise, ``seconds + step * i`` long, and their
    JSONL manifest; returns the manifest's path."""
    entries = []
    for i in range(n):
        secs = seconds + step * i
        rng = np.random.default_rng(i)
        p = directory / f"utt{i}.wav"
        write_wav(p, rng.standard_normal(int(16000 * secs)) * 0.09)
        e = {"audio_filepath": str(p), "text": text, "duration": secs}
        if extra:
            e.update(extra(i))
        entries.append(e)
    m = directory / "train.jsonl"
    m.write_text("\n".join(json.dumps(e) for e in entries))
    return str(m)
