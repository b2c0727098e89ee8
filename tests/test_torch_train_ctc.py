"""The port's CTC trainer against the JAX package's, and its CLI.

One step at ASRConfig.tiny: the loss within 1e-5 and every encoder
leaf's gradient within 1e-4 relative L2 of ``jax.value_and_grad`` on the
same weights (the JAX init, carried over) and the same numpy batch.  The
CLI (``python -m asr_streaming_tpu_torch.train.run --tiny --device
cpu``) takes 3 steps on a 4-wav manifest, resumes, and its checkpoint
loads into the JAX package's ``load_params`` and into the port's.  The
trainers' Emformer runs the eager route whatever ASR_PALLAS_MODE says,
and a kernel wrapper refuses a call autograd would record (fault 16).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models.asr import (
    ASRConfig as JASRConfig, init_asr_params as j_init_asr_params,
)
from asr_streaming_tpu.train import ctc as jctc
from asr_streaming_tpu.utils.checkpoint import load_params as j_load_params
from asr_streaming_tpu_torch.models.asr import (
    ASRConfig, init_asr_params, with_kernel_route,
)
from asr_streaming_tpu_torch.ops import _cuda
from asr_streaming_tpu_torch.train import ctc as tctc
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train.run import main as run_main
from asr_streaming_tpu_torch.utils.checkpoint import load_params
from tests.torch_train_common import (
    assert_trees_rel_l2, noise_manifest, pairs, to_torch,
)

VOCAB = 24


def _batch(seed=0, B=2, T_mel=100, L=6):
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, T_mel, 128)).astype(np.float32)
    feat_lens = np.array([T_mel, T_mel - 37], np.int32)[:B]
    labels = rng.integers(1, VOCAB, (B, L)).astype(np.int32)
    label_lens = np.array([L, L - 2], np.int32)[:B]
    labels[1, label_lens[1]:] = 0
    return feats, feat_lens, labels, label_lens


def test_ctc_step_matches_jax():
    jcfg = JASRConfig.tiny(vocab_size=VOCAB)
    cfg = tctc.training_config(ASRConfig.tiny(vocab_size=VOCAB))
    jparams = j_init_asr_params(jax.random.PRNGKey(3), jcfg)
    arrays = _batch()
    jbatch = jctc.Batch(*(jnp.asarray(a) for a in arrays))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda e: jctc.ctc_loss_fn({"encoder": e}, jcfg, jbatch)))(
            jparams["encoder"])

    tparams = to_torch(jparams)
    tbatch = tctc.Batch(*(torch.from_numpy(a) for a in arrays))
    loss, grads = optim.value_and_grad(
        lambda e: tctc.ctc_loss_fn({"encoder": e}, cfg, tbatch),
        tparams["encoder"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert_trees_rel_l2(grads, jgrads, 1e-4)
    for path, g, _ in pairs(grads, jgrads):
        assert np.isfinite(g).all() and np.any(g), path

    # the step: the same loss, the encoder moved, the frontend kept
    opt = tctc.make_optimizer(cfg, base_lr=0.5, warmup_steps=10)
    new, _, step_loss = tctc.make_train_step(cfg, opt)(
        tparams, opt.init(tparams["encoder"]), tbatch)
    assert float(step_loss) == float(loss)
    for path, a, b in pairs(new["frontend"], tparams["frontend"]):
        np.testing.assert_array_equal(a, b)
    assert all(not np.array_equal(a, b) for _, a, b in
               pairs(new["encoder"], tparams["encoder"]))


@pytest.mark.parametrize("mode", ["stack", "layer"])
def test_trainers_run_the_eager_route_whatever_the_environment(
        monkeypatch, mode):
    from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
    from asr_streaming_tpu_torch.train import rnnt as trnnt

    monkeypatch.setenv("ASR_PALLAS_MODE", mode)
    monkeypatch.setenv("ASR_PALLAS_QUANT", "int8")
    served = with_kernel_route(ASRConfig.tiny(), "stack")
    assert served.encoder.emformer.route == mode
    emf = tctc.training_config(served).encoder.emformer
    assert (emf.route, emf.quant, emf.fused_attention) == \
        ("eager", "none", False)
    assert trnnt.training_config(RNNTConfig.tiny()).emformer.route == "eager"

    # the loss functions take the eager route from a served config: the
    # kernel routes' wrappers are never reached
    from asr_streaming_tpu_torch.models import emformer as temf

    def no_kernel(*args, **kwargs):
        raise AssertionError("a kernel route ran under a trainer")
    monkeypatch.setattr(temf, "emformer_stack", no_kernel)
    monkeypatch.setattr(temf, "emformer_layer", no_kernel)
    feats, feat_lens, labels, label_lens = _batch(T_mel=70)
    params = init_asr_params(torch.Generator().manual_seed(0),
                             with_kernel_route(ASRConfig.tiny(VOCAB)), "cpu")
    batch = tctc.Batch(*(torch.from_numpy(a) for a in
                         (feats, feat_lens, labels, label_lens)))
    loss = tctc.ctc_loss_fn(params, with_kernel_route(ASRConfig.tiny(VOCAB)),
                            batch)
    assert np.isfinite(float(loss))


def test_kernel_guard_refuses_what_autograd_would_record():
    """The wrappers' CUDA branches call ``_cuda.refuse_grad`` on their
    inputs (fault 16); the guard itself is device-free."""
    w = torch.ones(3, requires_grad=True)
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="no backward"):
        _cuda.refuse_grad("emformer_stack", {"w": [x, w]}, x)
    with pytest.raises(RuntimeError, match="eager"):
        _cuda.refuse_grad("row_topk", w * 2)
    with torch.no_grad():
        _cuda.refuse_grad("emformer_stack", {"w": w}, x)
    _cuda.refuse_grad("emformer_stack", {"w": w.detach()}, x,
                      torch.ones(3, dtype=torch.int32), None)


@pytest.fixture(scope="module")
def manifest(tmp_path_factory):
    return noise_manifest(tmp_path_factory.mktemp("ctc_data"))


def _cli(manifest, ckpt, steps, *extra):
    return run_main([
        "--manifest", manifest, "--steps", str(steps), "--batch-size", "2",
        "--tiny", "--save", str(ckpt), "--save-every", "100",
        "--buckets-seconds", "2", "4", "--token-bucket", "16",
        "--warmup-steps", "10", "--device", "cpu", *extra])


def test_cli_trains_resumes_and_saves_the_jax_layout(manifest, tmp_path):
    ckpt = tmp_path / "ckpt.npz"
    log = _cli(manifest, ckpt, 3)
    assert len(log.losses) == 3 and np.isfinite(log.losses).all()

    like = j_init_asr_params(jax.random.PRNGKey(0),
                             JASRConfig.tiny(vocab_size=VOCAB))
    jloaded = j_load_params(str(ckpt), like=like)
    assert set(jloaded) == set(like) == {"frontend", "encoder"}
    tlike = init_asr_params(torch.Generator().manual_seed(0),
                            ASRConfig.tiny(vocab_size=VOCAB), "cpu")
    tloaded = load_params(str(ckpt), like=tlike)
    for path, a, b in pairs(tloaded, jloaded):
        np.testing.assert_array_equal(a, b, err_msg=path)
    # the frontend buffers are the JAX package's (nothing trained them)
    for path, a, b in pairs(tloaded["frontend"], like["frontend"]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6,
                                   err_msg=path)

    log2 = _cli(manifest, ckpt, 2, "--resume", str(ckpt))
    assert np.isfinite(log2.losses).all()
    resumed = load_params(str(ckpt), like=tlike)
    assert any(not np.array_equal(a, b) for _, a, b in
               pairs(resumed["encoder"], tloaded["encoder"]))


def test_cli_refuses_model_parallel(manifest, tmp_path, monkeypatch):
    """--model-parallel 2 in a world of one process raises, naming
    torchrun (tests/test_torch_train_dist.py runs it under torchrun)."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        _cli(manifest, tmp_path / "x.npz", 1, "--model-parallel", "2")
