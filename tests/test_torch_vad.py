"""The port's Silero ONNX import against the JAX package's: the same
initializers (a model written by tools/onnx_weights.py::encode_test_model
under the real v5 names, as tests/test_silero_import.py builds it) give
the same params and, through each package's VAD, the same speech
probabilities; the server's ``vad_weights`` loader takes the ``.onnx``
file and its converted ``.npz`` alike."""

import numpy as np
import torch

import jax.numpy as jnp

from asr_streaming_tpu.models.vad import (
    silero_chunk_probs as j_chunk_probs,
    silero_params_from_onnx as j_from_onnx,
)
from asr_streaming_tpu.tools.onnx_weights import (
    encode_test_model as j_encode, parse_onnx_initializers as j_parse,
)
from asr_streaming_tpu_torch.models.serving import ServingConfig
from asr_streaming_tpu_torch.models.vad import (
    SileroConfig, init_silero_params, load_vad_weights,
    silero_chunk_probs, silero_params_from_onnx,
)
from asr_streaming_tpu_torch.tools.onnx_weights import (
    convert_silero, encode_test_model, parse_onnx_initializers,
)
from asr_streaming_tpu_torch.utils.checkpoint import params_from_numpy
from tests.test_silero_import import _v5_initializers

CFG = SileroConfig()


def test_onnx_import_matches_the_jax_package(tmp_path):
    inits = _v5_initializers(seed=4)
    blob = encode_test_model(inits)
    assert blob == j_encode(inits)
    parsed = parse_onnx_initializers(blob)
    j_parsed = j_parse(blob)
    assert sorted(parsed) == sorted(j_parsed)
    for k in parsed:
        np.testing.assert_array_equal(parsed[k], j_parsed[k])

    params = silero_params_from_onnx(parsed, CFG)
    j_params = j_from_onnx(j_parsed)
    like = init_silero_params(torch.Generator().manual_seed(0), CFG, "cpu")
    assert sorted(params) == sorted(j_params) == sorted(like)
    for k in params:
        assert params[k].shape == tuple(like[k].shape), k
        np.testing.assert_array_equal(params[k], np.asarray(j_params[k]))

    wave = (np.random.default_rng(5).standard_normal((3, 2048)) * 0.3
            ).astype(np.float32)
    got = silero_chunk_probs(params_from_numpy(params, "cpu"), CFG,
                             torch.from_numpy(wave)).numpy()
    want = np.asarray(j_chunk_probs(j_params, CFG, jnp.asarray(wave)))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)

    # the server's vad_weights: the raw .onnx, or the .npz converted from it
    onnx_path = tmp_path / "silero_vad.onnx"
    onnx_path.write_bytes(blob)
    npz_path = tmp_path / "vad.npz"
    convert_silero(str(onnx_path), str(npz_path))
    for path in (onnx_path, npz_path):
        loaded = load_vad_weights(str(path), ServingConfig())
        for k in params:
            np.testing.assert_array_equal(loaded[k], params[k])
