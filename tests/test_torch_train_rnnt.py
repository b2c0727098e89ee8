"""The port's RNN-T trainer against the JAX package's (RNNTConfig.tiny).

``streaming_features`` (one ``log_mel`` over the stacked chunks) equals
the JAX featurizer within 1e-5.  One step, offline and on streaming
features: the loss within 1e-5 and every leaf's gradient within 1e-4
relative L2 of ``jax.value_and_grad``, on the JAX init carried over.
The CLI runs at ``--tiny --device cpu`` in both featurizer modes.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models.rnnt import (
    RNNTConfig as JRNNTConfig, init_rnnt_params as j_init_rnnt_params,
)
from asr_streaming_tpu.ops.frontend import (
    MelConfig as JMelConfig, make_mel_params as j_make_mel_params,
)
from asr_streaming_tpu.train import rnnt as jrnnt
from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
from asr_streaming_tpu_torch.ops.frontend import MelConfig, make_mel_params
from asr_streaming_tpu_torch.train import optim
from asr_streaming_tpu_torch.train import rnnt as trnnt
from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
from tests.torch_train_common import (
    assert_trees_rel_l2, pairs, to_torch, write_wav,
)

JCFG, CFG = JRNNTConfig.tiny(), RNNTConfig.tiny()
WANT = (CFG.emformer.segment_length + CFG.emformer.right_context_length) * 4
SEG, BUF = EN_AUDIO.segment_length, EN_AUDIO.buffer_length


def _streaming_feats(waves):
    jmel = dataclasses.replace(JMelConfig.for_english(), n_mels=CFG.n_mels)
    tmel = dataclasses.replace(MelConfig.for_english(), n_mels=CFG.n_mels)
    want = jrnnt.streaming_features(j_make_mel_params(jmel), jmel,
                                    jnp.asarray(waves), SEG, BUF, WANT)
    got = trnnt.streaming_features(make_mel_params(tmel, "cpu"), tmel,
                                   torch.from_numpy(waves), SEG, BUF, WANT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    return np.array(want)


@pytest.mark.parametrize("mode", ["offline", "streaming"])
def test_rnnt_step_matches_jax(mode):
    rng = np.random.default_rng(4)
    B = 2
    if mode == "streaming":
        waves = (rng.standard_normal((B, 4 * SEG)) * 0.1).astype(np.float32)
        feats = _streaming_feats(waves)
        feat_lens = np.array([4, 3], np.int32)           # valid chunks
    else:
        feats = rng.standard_normal((B, 40, CFG.n_mels)).astype(np.float32)
        feat_lens = np.array([40, 29], np.int32)         # mel frames
    targets = rng.integers(0, CFG.blank, (B, 4)).astype(np.int32)
    target_lens = np.array([4, 2], np.int32)
    arrays = (feats, feat_lens, targets, target_lens)

    jparams = j_init_rnnt_params(jax.random.PRNGKey(2), JCFG)
    jbatch = jrnnt.RNNTBatch(*(jnp.asarray(a) for a in arrays))
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jrnnt.rnnt_loss_fn(p, JCFG, jbatch)))(jparams)

    tparams = to_torch(jparams)
    tbatch = trnnt.RNNTBatch(*(torch.from_numpy(a) for a in arrays))
    loss, grads = optim.value_and_grad(
        lambda p: trnnt.rnnt_loss_fn(p, CFG, tbatch), tparams)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5,
                               atol=1e-5)
    assert_trees_rel_l2(grads, jgrads, 1e-4)

    opt = optim.adamw(3e-4, weight_decay=1e-4)
    new, _, step_loss = trnnt.make_rnnt_train_step(CFG, opt)(
        tparams, opt.init(tparams), tbatch)
    assert float(step_loss) == float(loss)
    assert all(not np.array_equal(a, b)
               for _, a, b in pairs(new, tparams))


@pytest.mark.parametrize("streaming", [False, True])
def test_rnnt_cli_tiny(tmp_path, streaming):
    rng = np.random.default_rng(0)
    entries = []
    for i in range(2):
        p = tmp_path / f"e{i}.wav"
        write_wav(p, rng.standard_normal(8000) * 0.09)
        entries.append({"audio_filepath": str(p), "text": "hello world"})
    manifest = tmp_path / "en.jsonl"
    manifest.write_text("\n".join(json.dumps(e) for e in entries))
    out = tmp_path / "rnnt.npz"
    log = trnnt.main(["--manifest", str(manifest), "--steps", "2",
                      "--batch-size", "2", "--seconds", "0.5", "--tiny",
                      "--save", str(out), "--device", "cpu"]
                     + (["--streaming-features"] if streaming else []))
    assert len(log.losses) == 2 and np.isfinite(log.losses).all()
    from asr_streaming_tpu_torch.utils.checkpoint import load_params
    saved = load_params(str(out))
    assert set(saved) == {"input_linear", "emformer", "enc_out",
                          "predictor", "joiner"}
