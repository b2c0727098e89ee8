"""Helpers shared by the port's training parity tests
(tests/test_torch_train_*.py): JAX trees carried into torch, tree
comparisons by relative L2, synthetic wav manifests."""

import json
import wave as wave_mod

import numpy as np
import torch

import jax

from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy


def to_torch(jtree, device="cpu"):
    """A JAX parameter tree (dicts and lists of arrays) as f32 tensors."""
    return params_from_numpy(jax.tree.map(np.asarray, jtree), device)


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
