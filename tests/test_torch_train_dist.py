"""The port's data- and tensor-parallel CTC training on torch.distributed,
against its single-process step and against the JAX package's sharded one.

One spawn of four ``gloo`` ranks (train/dist_check.py) runs the layouts
data x model 2 x 1, 1 x 2 and 2 x 2 in turn at the geometry of the JAX
package's own sharded-step test (tests/test_multichip.py), on the JAX
init's weights: the loss within 1e-5 relative, each gathered gradient leaf
within 1e-4 relative L2 and the updated weights within 1e-5 of the
single-process step; the 2 x 2 loss within 1e-4 of JAX's (data=4, model=2)
sharded loss and its gradients within 1e-4 relative L2 of ``jax.grad``.
Then the layout itself (shard and gather, the mesh's order, the data-axis
rule) and the CLI under ``torch.distributed.run``.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from asr_streaming_tpu.models.asr import (
    ASRConfig as JASRConfig, init_asr_params as j_init_asr_params,
)
from asr_streaming_tpu.models.emformer import (
    EmformerConfig as JEmformerConfig,
)
from asr_streaming_tpu.models.encoder import EncoderConfig as JEncoderConfig
from asr_streaming_tpu.parallel.mesh import (
    make_mesh as j_make_mesh, param_pspecs as j_param_pspecs,
    shard_params as j_shard_params,
)
from asr_streaming_tpu.train import ctc as jctc
from asr_streaming_tpu.utils.checkpoint import load_params as j_load_params
from asr_streaming_tpu_torch.models.asr import ASRConfig, init_asr_params
from asr_streaming_tpu_torch.parallel.mesh import (
    DeviceMesh, batch_pspec, data_parallel_for_batch, gather_params,
    make_mesh, param_pspecs, shard_batch, shard_params,
)
from asr_streaming_tpu_torch.train import ctc as tctc
from asr_streaming_tpu_torch.train import dist_check
from asr_streaming_tpu_torch.train.run import main as run_main
from asr_streaming_tpu_torch.utils.checkpoint import load_params
from tests.torch_train_common import (  # noqa: F401  (one_torch_thread)
    assert_trees_rel_l2, noise_manifest, one_torch_thread, pairs,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_config():
    emf = JEmformerConfig(d_model=32, num_heads=4, ffn_dim=64, num_layers=2)
    return JASRConfig(encoder=JEncoderConfig(
        input_dim=128, d_model=32, vocab_size=dist_check.VOCAB,
        ctc_hidden_dim=32, emformer=emf))


@pytest.fixture(scope="module")
def jax_side():
    """The JAX init's weights, the global batch, JAX's (data=4, model=2)
    sharded loss (tests/test_multichip.py's step) and the unsharded
    ``jax.grad``."""
    cfg = _jax_config()
    params = j_init_asr_params(jax.random.PRNGKey(0), cfg)
    arrays = dist_check.tiny_batch()
    batch = jctc.Batch(*(jnp.asarray(arrays[k]) for k in jctc.Batch._fields))
    loss, grads = jax.jit(jax.value_and_grad(
        lambda e: jctc.ctc_loss_fn({"encoder": e}, cfg, batch)))(
            params["encoder"])
    optimizer = jctc.make_optimizer(cfg, warmup_steps=dist_check.WARMUP)
    step = jax.jit(jctc.make_train_step(cfg, optimizer))
    mesh = j_make_mesh(8, model_parallel=2)
    with mesh:
        sp = j_shard_params(params, mesh)
        sb = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, P("data"))),
            batch)
        _, _, sharded_loss = step(sp, optimizer.init(sp["encoder"]), sb)
    return {"params": params, "arrays": arrays, "loss": float(loss),
            "grads": grads, "sharded_loss": float(sharded_loss)}


def test_dp_tp_steps_equal_the_single_process_step_and_jax(jax_side):
    cfg = tctc.training_config(dist_check.tiny_config())
    enc = jax.tree.map(np.asarray, jax_side["params"]["encoder"])
    arrays = jax_side["arrays"]
    want = dist_check.reference(enc, cfg, arrays, "cpu")
    got = dist_check.run_layouts(enc, cfg, arrays, "cpu")
    assert got["backend"] == "gloo"
    assert got["foreign_modules"] == []           # the spawned ranks
    key_bound = dist_check.bounds(cfg)["key_bias"]
    for layout in dist_check.LAYOUTS:
        err = dist_check.compare(got[layout], want)
        assert err["loss"] <= 1e-5, (layout, err)
        assert err["grads"] <= 1e-4, (layout, err)
        assert err["params"] <= 1e-5, (layout, err)
        assert err["key_bias"] <= key_bound, (layout, err)
        # every leaf moved and came back whole
        for path, a, b in pairs(got[layout]["params"], want["params"]):
            assert a.shape == b.shape, path

    two_by_two = got[(2, 2)]
    assert two_by_two["loss"] == pytest.approx(jax_side["sharded_loss"],
                                               rel=1e-4)
    assert want["loss"] == pytest.approx(jax_side["loss"], rel=1e-5)
    assert_trees_rel_l2(two_by_two["grads"], jax_side["grads"], 1e-4)


@pytest.mark.parametrize("mp", [2, 4])
def test_shard_gather_round_trip_is_exact(mp):
    """gather_params(shard_params(p)) == p bit for bit, from torch leaves
    and from the JAX package's numpy leaves; each rank's w_kv holds the K
    and the V columns of its own heads."""
    cfg = ASRConfig.tiny()
    whole = init_asr_params(torch.Generator().manual_seed(0), cfg, "cpu")
    whole["encoder"]["emformer"]["b_q"][0, 0] = -0.0
    mesh = make_mesh(devices=["cpu"] * (2 * mp), model_parallel=mp)
    for tree in (whole, jax.tree.map(lambda t: t.numpy(), whole)):
        row = [shard_params(tree, mesh, r) for r in range(mp)]
        for r in range(mp, 2 * mp):      # the second data row's shards
            for path, a, b in pairs(shard_params(tree, mesh, r),
                                    row[r % mp]):
                assert np.array_equal(a, b), path
        back = gather_params(row, mesh)
        for path, a, b in pairs(back, whole):
            assert a.dtype == b.dtype and np.array_equal(a, b), path
        assert torch.signbit(back["encoder"]["emformer"]["b_q"][0, 0])

    D = cfg.encoder.d_model
    w_kv = whole["encoder"]["emformer"]["w_kv"]
    width = D // mp
    for c in range(mp):
        shard = shard_params(whole, mesh, c)["encoder"]["emformer"]
        k, v = w_kv[..., :D], w_kv[..., D:]
        want = torch.cat([k[..., c * width:(c + 1) * width],
                          v[..., c * width:(c + 1) * width]], -1)
        assert torch.equal(shard["w_kv"], want)
        assert shard["w_q"].shape[-1] == width
        assert shard["w_out"].shape[1] == width
        assert shard["ff_w1"].shape[-1] == cfg.encoder.emformer.ffn_dim // mp
        assert torch.equal(shard["ln_in_scale"],
                           whole["encoder"]["emformer"]["ln_in_scale"])


def test_pspecs_follow_the_jax_layout():
    """The spec of every leaf is the JAX package's PartitionSpec."""
    jparams = j_init_asr_params(jax.random.PRNGKey(0), JASRConfig.tiny())
    jspecs = j_param_pspecs(jparams)
    tspecs = param_pspecs(jax.tree.map(np.asarray, jparams))
    flat = jax.tree_util.tree_flatten_with_path(
        jspecs, is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in flat:
        node = tspecs
        for k in path:
            node = node[k.key]
        assert tuple(spec) == node, (path, spec, node)
    assert batch_pspec() == tuple(P("data"))


def test_mesh_order_and_shape_follow_jax():
    mesh = make_mesh(devices=["cpu"] * 8, model_parallel=2)
    assert mesh.shape == {"data": 4, "model": 2}
    jmesh = j_make_mesh(8, model_parallel=2)
    assert dict(jmesh.shape) == mesh.shape
    for rank in range(8):
        assert jmesh.devices[mesh.coords(rank)] == jax.devices()[rank]
    assert make_mesh(devices=["cpu"] * 4, model_parallel=4).shape == \
        {"data": 1, "model": 4}
    with pytest.raises(ValueError, match="model groups of 3"):
        make_mesh(devices=["cpu"] * 4, model_parallel=3)
    with pytest.raises(ValueError, match="divide num_heads=4"):
        tctc.make_train_step(ASRConfig.tiny(), None, _groups(3))


def _groups(mp):
    from asr_streaming_tpu_torch.parallel.collectives import ParallelGroups
    return ParallelGroups(DeviceMesh((torch.device("cpu"),) * mp, mp), 0,
                          None, None)


def test_data_axis_rule_and_batch_rows():
    """train/run.py:87-90's rule: the largest divisor of the batch that
    fits the ranks of one model column."""
    for world in range(1, 9):
        for mp in (1, 2, 4):
            if world < mp:
                continue
            for bs in (1, 2, 3, 6, 8, 12):
                avail = world // mp
                want = max(d for d in range(1, avail + 1) if bs % d == 0)
                assert data_parallel_for_batch(world, mp, bs) == want
    mesh = make_mesh(devices=["cpu"] * 4, model_parallel=2)
    rows = np.arange(8 * 3).reshape(8, 3)
    batch = tctc.Batch(rows, rows[:, 0], rows, rows[:, 0])
    for rank in range(4):
        part = shard_batch(batch, mesh, rank)
        assert isinstance(part, tctc.Batch)
        first = (rank // 2) * 4
        np.testing.assert_array_equal(part.feats, rows[first:first + 4])


def test_torchrun_cli_trains_tensor_parallel(tmp_path):
    """``torch.distributed.run`` with two ranks at ``--model-parallel 2``:
    its checkpoint loads into the JAX ``load_params`` with equal keys and
    shapes, and equals the single-process CLI's after the same two steps
    (the key half of ``b_kv`` apart: train/dist_check.py::compare) within
    1e-4, about 1% of the second step's learning rate: Adam divides each
    gradient element by its own running size, so an element small against
    its leaf turns the leaf's rounding (1e-6 relative L2) into a larger
    share of its update."""
    manifest = noise_manifest(tmp_path)
    common = ["--manifest", manifest, "--steps", "2", "--batch-size", "2",
              "--tiny", "--save-every", "100", "--buckets-seconds", "2", "4",
              "--token-bucket", "16", "--warmup-steps", "10",
              "--device", "cpu"]
    ckpt = tmp_path / "tp.npz"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": REPO}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(dist_check.free_port()),
         "-m", "asr_streaming_tpu_torch.train.run", *common,
         "--model-parallel", "2", "--save", str(ckpt)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert re.search(r"rank 1 of 2 on cpu over gloo", proc.stderr)
    assert "mesh: {'data': 1, 'model': 2} of 2 ranks" in proc.stderr

    single = tmp_path / "single.npz"
    log = run_main([*common, "--save", str(single)])
    assert len(log.losses) == 2

    like = j_init_asr_params(jax.random.PRNGKey(0),
                             JASRConfig.tiny(vocab_size=len(_vocab())))
    jloaded = j_load_params(str(ckpt), like=like)
    flat_like = jax.tree_util.tree_flatten_with_path(like)[0]
    flat_got = jax.tree_util.tree_flatten_with_path(jloaded)[0]
    assert [p for p, _ in flat_like] == [p for p, _ in flat_got]
    for (_, a), (_, b) in zip(flat_like, flat_got):
        assert a.shape == b.shape
    tp, want = load_params(str(ckpt)), load_params(str(single))
    for path, a, b in pairs(tp, want):
        if path.endswith("/b_kv"):
            a, b = np.split(a, 2, -1)[1], np.split(b, 2, -1)[1]
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4, err_msg=path)


def _vocab():
    from asr_streaming_tpu_torch.text.corpus import load_corpus
    from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
    vocab, _ = load_corpus()
    return vocab or placeholder_vocab(24)
