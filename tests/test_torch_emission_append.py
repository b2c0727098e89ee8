"""The port's emission append vs the JAX package's (exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from asr_streaming_tpu.models.serving import _pack_f16_rows, _unpack_f16_rows
from asr_streaming_tpu.ops.pallas_append import (
    emission_append as jax_append_kernel, emission_append_xla,
)
from asr_streaming_tpu_torch.ops import emission_append as ea


def _case(B, max_t, U, V, seed):
    rng = np.random.default_rng(seed)
    buf = rng.standard_normal((B, max_t, V)).astype(np.float16)
    rows = rng.standard_normal((B, U, V)).astype(np.float32)
    pos = (rng.integers(0, max_t // U, B) * U).astype(np.int32)
    decode = rng.integers(0, 2, B).astype(bool)
    return buf, rows, pos, decode


@pytest.mark.parametrize("B,max_t,U,V", [
    (8, 64, 16, 37),       # CTC-shaped, unaligned vocab
    (5, 32, 4, 24),        # RNNT-shaped
    (3, 48, 16, 803),      # the VI vocab width
])
def test_matches_jax_xla_and_interpreted_kernel(B, max_t, U, V):
    buf, rows, pos, decode = _case(B, max_t, U, V, seed=B)
    got = ea.emission_append(torch.from_numpy(buf.copy()),
                             torch.from_numpy(rows), torch.from_numpy(pos),
                             torch.from_numpy(decode)).numpy()
    want = np.asarray(emission_append_xla(
        jnp.asarray(buf), jnp.asarray(rows), jnp.asarray(pos),
        jnp.asarray(decode)))
    np.testing.assert_array_equal(got, want)
    if max_t % 16 == 0:
        # the Pallas kernel, interpreted, on the f32 layout it serves
        kern = np.asarray(jax_append_kernel(
            jnp.asarray(buf.astype(np.float32)),
            jnp.asarray(rows.astype(np.float16).astype(np.float32)),
            jnp.asarray(pos), jnp.asarray(decode), interpret=True))
        np.testing.assert_array_equal(got.astype(np.float32), kern)


def test_untouched_rows_stay_and_decode_none_is_identity():
    buf, rows, pos, _ = _case(4, 32, 8, 16, seed=1)
    t = torch.from_numpy(buf.copy())
    ea.emission_append(t, torch.from_numpy(rows), torch.from_numpy(pos),
                       torch.zeros(4, dtype=torch.bool))
    np.testing.assert_array_equal(t.numpy(), buf)


def test_f16_fetch_equals_jax_packed_storage_unpacked():
    """The port stores native f16; JAX packs f16 pairs into f32 words and
    unpacks on the host.  The fetched rows are identical."""
    B, max_t, U, V = 3, 32, 8, 21
    rng = np.random.default_rng(2)
    rows = rng.standard_normal((B, U, V)).astype(np.float32) * 5
    pos = np.array([0, 8, 16], np.int32)
    decode = np.array([True, True, False])
    jbuf = jnp.zeros((B, max_t, (V + 1) // 2), jnp.float32)
    jbuf = emission_append_xla(jbuf, _pack_f16_rows(jnp.asarray(rows)),
                               jnp.asarray(pos), jnp.asarray(decode))
    tbuf = torch.zeros((B, max_t, V), dtype=torch.float16)
    ea.emission_append(tbuf, torch.from_numpy(rows), torch.from_numpy(pos),
                       torch.from_numpy(decode))
    for b in range(B):
        want = _unpack_f16_rows(np.asarray(jbuf)[b], V)
        got = tbuf[b].float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("V", [803, 1024], ids=["vi_misaligned", "en_aligned"])
def test_plain_at_both_ends_and_out_of_range(V):
    """pos at 0 and at MAX_T - U: the same inputs through the JAX package's
    append, compared on those slots.  A pos outside [0, MAX_T - U] is left
    undefined by the JAX append (its slice clamps there); the port writes
    nothing, as its kernel does, so those slots are held to the untouched
    buffer and not to the JAX output."""
    B, max_t, U = 6, 40, 5
    buf, rows, _, _ = _case(B, max_t, U, V, seed=V)
    pos = np.array([0, max_t - U, 0, max_t - U, -1, max_t - U + 1], np.int32)
    decode = np.array([True, True, False, True, True, True])
    got = ea.emission_append(torch.from_numpy(buf.copy()),
                             torch.from_numpy(rows), torch.from_numpy(pos),
                             torch.from_numpy(decode)).numpy()
    want = np.asarray(emission_append_xla(
        jnp.asarray(buf), jnp.asarray(rows), jnp.asarray(pos),
        jnp.asarray(decode)))
    np.testing.assert_array_equal(got[:4], want[:4])
    np.testing.assert_array_equal(got[1, max_t - U:],
                                  rows[1].astype(np.float16))
    # out of range: the buffer unchanged
    np.testing.assert_array_equal(got[4:], buf[4:])
