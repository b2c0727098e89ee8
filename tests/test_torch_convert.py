"""The port's checkpoint converters and ``load_params_auto``.

Synthetic torch state dicts with the reference's names and shapes (the
helpers of tests/test_convert_checkpoint.py, test_convert_rnnt.py and
test_ecapa_convert.py) go through both packages' converters, and through
both packages' ``load_params_auto`` as a Vietnamese Lightning ``.ckpt``
(nested and flat-prefixed), an English torchaudio ``.pt`` and a partial
``.npz``, each merged onto one template shared by the two packages.  The
flat trees must be identical, key for key and bit for bit; a key the
template lacks raises ``KeyError`` in both.
"""

import numpy as np
import pytest
import torch

import jax

from asr_streaming_tpu.models.asr import ASRConfig as JASRConfig
from asr_streaming_tpu.models.emformer import EmformerConfig as JEmformer
from asr_streaming_tpu.models.encoder import EncoderConfig as JEncoder
from asr_streaming_tpu.models.serving import (
    ServingConfig as JServingConfig, init_serving_params as j_init,
)
from asr_streaming_tpu.tools import convert_checkpoint as jconv
from asr_streaming_tpu.tools import convert_ecapa as jconv_ecapa
from asr_streaming_tpu.tools import convert_rnnt_checkpoint as jconv_rnnt
from asr_streaming_tpu.utils import checkpoint as jckpt
from asr_streaming_tpu_torch.models.ecapa import (
    EcapaConfig, load_ecapa_weights,
)
from asr_streaming_tpu_torch.tools import convert_checkpoint as tconv
from asr_streaming_tpu_torch.tools import convert_ecapa as tconv_ecapa
from asr_streaming_tpu_torch.tools import convert_rnnt_checkpoint as tconv_rnnt
from asr_streaming_tpu_torch.utils import checkpoint as tckpt
from tests.test_convert_checkpoint import (
    D, FFN, H, L, MELS, V, _synthetic_reference_state_dicts,
)
from tests.test_convert_rnnt import CFG as RNNT_CFG
from tests.test_convert_rnnt import L as RNNT_L
from tests.test_convert_rnnt import PL as RNNT_PL
from tests.test_convert_rnnt import synthetic_sd  # noqa: F401
from tests.test_ecapa_convert import CFG as J_ECAPA_CFG
from tests.test_ecapa_convert import synthetic_state_dict

ECAPA_CFG = EcapaConfig(**{f: getattr(J_ECAPA_CFG, f) for f in (
    "n_mels", "channels", "res2net_scale", "se_bottleneck",
    "attention_channels", "embedding_dim", "dilations")})


def _jflat(tree):
    return jckpt._flatten(jax.tree.map(np.asarray, tree))


def _tflat(tree):
    return tckpt._flatten(tree)


def assert_same_flat(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _vi_templates():
    jcfg = JServingConfig(
        asr=JASRConfig(encoder=JEncoder(
            input_dim=MELS, d_model=D, vocab_size=V, ctc_hidden_dim=H,
            emformer=JEmformer(d_model=D, num_heads=4, ffn_dim=FFN,
                               num_layers=L))),
        use_silero=False)
    jt = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    return jt, tckpt.params_from_numpy(jt, "cpu")


def _en_templates():
    jcfg = JServingConfig(asr=JASRConfig.tiny(), model_kind="rnnt",
                          rnnt=RNNT_CFG, use_silero=False)
    jt = jax.tree.map(np.asarray, j_init(jax.random.PRNGKey(0), jcfg))
    return jt, tckpt.params_from_numpy(jt, "cpu")


def test_converters_equal_the_jax_converters(synthetic_sd):  # noqa: F811
    enc, dec = _synthetic_reference_state_dicts()
    assert_same_flat(
        _jflat(jconv.convert_encoder_state_dict(enc, num_layers=L)),
        _tflat(tconv.convert_encoder_state_dict(enc, num_layers=L)))
    assert_same_flat(_jflat(jconv.convert_ctc_state_dict(dec)),
                     _tflat(tconv.convert_ctc_state_dict(dec)))
    assert_same_flat(
        _jflat(jconv_rnnt.convert_rnnt_state_dict(
            synthetic_sd, num_layers=RNNT_L, pred_layers=RNNT_PL)),
        _tflat(tconv_rnnt.convert_rnnt_state_dict(
            synthetic_sd, num_layers=RNNT_L, pred_layers=RNNT_PL)))
    sd = synthetic_state_dict(J_ECAPA_CFG)
    assert_same_flat(
        _jflat(jconv_ecapa.convert_ecapa_state_dict(sd, J_ECAPA_CFG)),
        _tflat(tconv_ecapa.convert_ecapa_state_dict(sd, ECAPA_CFG)))


@pytest.mark.parametrize("layout", ["nested", "flat"])
def test_vi_ckpt_loads_identically(layout, tmp_path):
    enc, dec = _synthetic_reference_state_dicts()
    if layout == "nested":
        sd = {"encoder": enc, "decoder": dec}
    else:
        sd = {**{"encoder." + k: v for k, v in enc.items()},
              **{"decoder." + k: v for k, v in dec.items()}}
    path = str(tmp_path / "asr-online.ckpt")
    torch.save({"state_dict": sd, "hyper_parameters": {}}, path)
    jt, tt = _vi_templates()
    got = tckpt.load_params_auto(path, like=tt)
    want = jckpt.load_params_auto(path, like=jt)
    assert_same_flat(_jflat(want), _tflat(got))
    # the converted encoder replaced the template's
    np.testing.assert_array_equal(
        got["encoder"]["ctc"]["w2"].numpy(), dec["linear2.weight"].numpy().T)


def test_en_pt_loads_identically(synthetic_sd, tmp_path):  # noqa: F811
    path = str(tmp_path / "emformer_rnnt.pt")
    torch.save(synthetic_sd, path)
    jt, tt = _en_templates()
    got = tckpt.load_params_auto(path, like=tt)
    want = jckpt.load_params_auto(path, like=jt)
    assert_same_flat(_jflat(want), _tflat(got))
    np.testing.assert_array_equal(
        got["joiner"]["b"].numpy(), synthetic_sd["joiner.linear.bias"])


def test_partial_npz_merges_identically(tmp_path):
    jt, tt = _vi_templates()
    rng = np.random.default_rng(3)
    part = {"encoder": {"ctc": {
        k: rng.standard_normal(v.shape).astype(np.float32)
        for k, v in jt["encoder"]["ctc"].items()}}}
    path = str(tmp_path / "am.npz")
    jckpt.save_params(path, part)
    got = tckpt.load_params_auto(path, like=tt)
    want = jckpt.load_params_auto(path, like=jt)
    assert_same_flat(_jflat(want), _tflat(got))
    np.testing.assert_array_equal(got["encoder"]["ctc"]["b2"].numpy(),
                                  part["encoder"]["ctc"]["b2"])
    # what the checkpoint lacks keeps the template's values
    np.testing.assert_array_equal(got["vad"]["lstm_wi"].numpy(),
                                  jt["vad"]["lstm_wi"])


@pytest.mark.parametrize("where", ["top", "nested"])
def test_unknown_keys_raise_in_both(where, tmp_path):
    jt, tt = _vi_templates()
    extra = ({"bogus": np.zeros(3, np.float32)} if where == "top" else
             {"encoder": {"ctc": {"w9": np.zeros(3, np.float32)}}})
    path = str(tmp_path / "bad.npz")
    jckpt.save_params(path, extra)
    with pytest.raises(KeyError):
        jckpt.load_params_auto(path, like=jt)
    with pytest.raises(KeyError):
        tckpt.load_params_auto(path, like=tt)


@pytest.mark.parametrize("suffix", [".ckpt", ".pt"])
def test_ecapa_checkpoint_loads_as_the_jax_server_converts_it(suffix,
                                                              tmp_path):
    """The server's ``speaker_weights`` as a speechbrain checkpoint: the
    port's load_ecapa_weights equals the JAX server's conversion
    (asr_streaming_tpu/server/__main__.py), the prefix stripped."""
    sd = {"embedding_model." + k: torch.from_numpy(v)
          for k, v in synthetic_state_dict(J_ECAPA_CFG).items()}
    path = str(tmp_path / f"embedding_model{suffix}")
    torch.save(sd, path)
    want = jconv_ecapa.convert_ecapa_state_dict(
        {k.removeprefix("embedding_model."): v for k, v in sd.items()},
        J_ECAPA_CFG)
    assert_same_flat(_jflat(want),
                     _tflat(load_ecapa_weights(path, ECAPA_CFG)))


def test_checkpoint_tools_write_the_same_npz(synthetic_sd, tmp_path):  # noqa: F811
    """The command-line halves: each port tool writes the .npz its JAX
    original writes."""
    enc, dec = _synthetic_reference_state_dicts()
    ckpt = str(tmp_path / "vi.ckpt")
    torch.save({"state_dict": {"encoder": enc, "decoder": dec}}, ckpt)
    pt = str(tmp_path / "en.pt")
    torch.save(synthetic_sd, pt)
    eck = str(tmp_path / "ecapa.ckpt")
    torch.save({k: torch.from_numpy(v)
                for k, v in synthetic_state_dict(J_ECAPA_CFG).items()}, eck)
    pairs = [
        (lambda o: jconv.convert_lightning_checkpoint(ckpt, o, L),
         lambda o: tconv.convert_lightning_checkpoint(ckpt, o, L)),
        (lambda o: jconv_rnnt.convert_rnnt_checkpoint(pt, o, RNNT_L,
                                                      RNNT_PL),
         lambda o: tconv_rnnt.convert_rnnt_checkpoint(pt, o, RNNT_L,
                                                      RNNT_PL)),
        (lambda o: jconv_ecapa.convert_ecapa_checkpoint(eck, o, J_ECAPA_CFG),
         lambda o: tconv_ecapa.convert_ecapa_checkpoint(eck, o, ECAPA_CFG)),
    ]
    for i, (jrun, trun) in enumerate(pairs):
        jout, tout = str(tmp_path / f"j{i}.npz"), str(tmp_path / f"t{i}.npz")
        jrun(jout)
        trun(tout)
        with np.load(jout) as a, np.load(tout) as b:
            assert_same_flat(dict(a), dict(b))
