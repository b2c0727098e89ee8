"""The port's .npz checkpoints vs the JAX package's (same format)."""

import os

import numpy as np
import torch

from asr_streaming_tpu.utils import checkpoint as jax_ckpt
from asr_streaming_tpu_torch.utils import checkpoint as pt_ckpt

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "assets", "test_fixtures", "overfit_ctc.npz")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}::{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def test_fixture_loads_same_keys_shapes_values():
    want = jax_ckpt.load_params(FIXTURE)
    want.pop("__meta__", None)
    got = pt_ckpt.load_params(FIXTURE)
    fw, fg = _flat(want), _flat(got)
    assert sorted(fw) == sorted(fg)
    for k in fw:
        assert fg[k].shape == fw[k].shape, k
        assert fg[k].dtype == fw[k].dtype, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=k)


def test_params_from_numpy_round_trip():
    tree = pt_ckpt.load_params(FIXTURE)
    tensors = pt_ckpt.params_from_numpy(tree, "cpu")
    assert isinstance(tensors["encoder"]["emformer"]["w_q"], torch.Tensor)
    back = _flat(tensors)          # np.asarray of each CPU tensor
    for k, v in _flat(tree).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
        assert back[k].dtype == v.dtype, k
    bf = pt_ckpt.params_from_numpy(tree, "cpu", dtype=torch.bfloat16)
    assert bf["encoder"]["ctc"]["w1"].dtype == torch.bfloat16


def test_save_load_with_template_both_packages(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": {"w": rng.standard_normal((3, 4)).astype(np.float32)},
            "b": np.arange(5, dtype=np.int32)}
    path = str(tmp_path / "p.npz")
    pt_ckpt.save_params(path, pt_ckpt.params_from_numpy(tree, "cpu"))
    like = {"a": {"w": torch.zeros(3, 4)}, "b": torch.zeros(5,
                                                            dtype=torch.int32)}
    got = pt_ckpt.load_params(path, like=like)
    assert got["b"].dtype == torch.int32
    np.testing.assert_array_equal(got["a"]["w"].numpy(), tree["a"]["w"])
    # the JAX package reads what the port writes
    jax_tree = jax_ckpt.load_params(path)
    np.testing.assert_array_equal(jax_tree["a"]["w"], tree["a"]["w"])
    np.testing.assert_array_equal(jax_tree["b"], tree["b"])
