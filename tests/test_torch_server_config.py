"""The port's server config loader and startup checks.

``ServerSettings.load`` of the port equals the JAX package's, field by
field as plain data, on every shipped config and on the reference-layout
file, with one intended difference: a flat ``endpoint_rules`` also
replaces ``endpoint_rulesets["DEFAULT"]``, so ``Stream`` serves it (the
JAX loader loses it when the file also has ``Endpointing_rules``).
``build_server`` hands ``quant`` to the device-worker child inside the
pickled config, splits the slots over a mesh for ``data_parallel``,
builds the speaker verifier of ``speaker_wav``, and never falls back to
the CPU; the worker child converts a ``.ckpt`` checkpoint at load.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import pytest

from asr_streaming_tpu.server.config import ServerSettings as JSettings
from asr_streaming_tpu_torch.server.__main__ import _check_ported, build_server
from asr_streaming_tpu_torch.server.config import ServerSettings
from asr_streaming_tpu_torch.streaming.stream import Stream
from asr_streaming_tpu_torch.text.vocab import placeholder_vocab

from tests.test_bootstrap_assets import fake_tree  # noqa: F401
from tests.test_convert_rnnt import synthetic_sd  # noqa: F401
from tests.test_reference_config import _write_reference_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))


def _plain(settings):
    return dataclasses.asdict(settings)


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_shipped_configs_load_as_the_jax_loader(path):
    assert _plain(ServerSettings.load(path, env={})) == \
        _plain(JSettings.load(path, env={}))


@pytest.mark.parametrize("language", ["vi", "en"])
def test_reference_layout_loads_as_the_jax_loader(fake_tree, language):  # noqa: F811
    path = _write_reference_yaml(fake_tree)
    env = {"LANGUAGE": language, "NORM_PORT": "8999"}
    port = ServerSettings.load(path, env=env)
    assert _plain(port) == _plain(JSettings.load(path, env=env))
    assert port.vad_weights and port.checkpoint   # the tree's assets mapped


FLAT_OVERRIDE = """
Endpointing_rules:
  DEFAULT:
    never:
      must_contain_nonsilence: true
      min_trailing_silence: 99
      min_utterance_length: 0.0
      max_relative_cost: .inf
Mapping_rule:
  GENERAL: DEFAULT
endpoint_rules:
  at_once:
    must_contain_nonsilence: false
    min_trailing_silence: 0.0
    min_utterance_length: 0.0
    max_relative_cost: .inf
"""


def test_flat_endpoint_rules_override_the_default_ruleset(tmp_path):
    """The one intended difference from the JAX loader."""
    path = tmp_path / "override.yaml"
    path.write_text(FLAT_OVERRIDE)
    s = ServerSettings.load(str(path), env={})
    j = JSettings.load(str(path), env={})
    assert list(s.endpoint_rules) == list(j.endpoint_rules) == ["at_once"]
    assert list(s.endpoint_rulesets["DEFAULT"]) == ["at_once"]
    assert list(j.endpoint_rulesets["DEFAULT"]) == ["never"]   # lost there
    assert {k: v for k, v in _plain(s).items() if k != "endpoint_rulesets"} \
        == {k: v for k, v in _plain(j).items() if k != "endpoint_rulesets"}
    stream = Stream(s.audio, placeholder_vocab(8), rules=s.endpoint_rules,
                    rulesets=s.endpoint_rulesets,
                    mapping_rule=s.mapping_rule)
    detected, _ = stream.check_endpoint()
    assert detected                      # "at_once" fired, not "never"


def _settings(**kw):
    s = ServerSettings.load(os.path.join(ROOT, "configs", "server-vi.yaml"),
                            env={})
    return dataclasses.replace(s, **kw)


def test_quant_reaches_the_device_worker_child():
    server = build_server(_settings(quant="int8"), max_slots=2, device="cpu")
    try:
        stats = server.scheduler.client.stats(timeout=300)
    finally:
        server.scheduler.close()
    assert stats["emformer"] == {"route": "stack", "quant": "int8"}
    assert stats["foreign_modules"] == []


@pytest.mark.parametrize("kw,item", [
    (dict(speaker_wav="enrolled.wav"), None),
    (dict(checkpoint="asr-online.ckpt"), None),
    (dict(data_parallel=0), "item 4"),
], ids=["speaker_wav", "ckpt", "data_parallel"])
def test_later_slice_settings_raise_naming_their_item(kw, item):
    """No setting of the JAX server is left for a later slice: speaker
    verification, ``.ckpt``/``.pt`` checkpoints and, since ROADMAP queue 1
    item 4, ``data_parallel`` (multi-GPU serving) pass the start-up
    check.  ``data_parallel: 0`` without the device worker splits the
    slots over every shard: on the CPU, the 8 CPU shards."""
    settings = _settings(**kw)
    _check_ported(settings)
    if item is None:
        return
    settings = dataclasses.replace(settings, device_worker=False)
    server = build_server(settings, max_slots=8, device="cpu")
    try:
        for group in server.scheduler.groups:      # scheduler_groups: 2
            assert group.mesh.shape == {"data": 8, "model": 1}
            assert {d.type for d in group.mesh.devices} == {"cpu"}
            assert len(group.device_state) == 8
    finally:
        server.scheduler.close()


def test_worker_child_converts_a_ckpt_checkpoint(tmp_path):
    """The device-worker child's loader takes a reference Lightning
    .ckpt, converted at load (load_params_auto), as the JAX child does."""
    import pickle

    import numpy as np
    import torch

    from asr_streaming_tpu_torch.models.asr import ASRConfig
    from asr_streaming_tpu_torch.models.emformer import EmformerConfig
    from asr_streaming_tpu_torch.models.encoder import EncoderConfig
    from asr_streaming_tpu_torch.models.serving import ServingConfig
    from asr_streaming_tpu_torch.streaming.device_worker import _DeviceSide
    from tests.test_convert_checkpoint import (
        D, FFN, H, L, MELS, V, _synthetic_reference_state_dicts,
    )

    enc, dec = _synthetic_reference_state_dicts()
    path = str(tmp_path / "asr-online.ckpt")
    torch.save({"state_dict": {"encoder": enc, "decoder": dec}}, path)
    cfg = ServingConfig(asr=ASRConfig(encoder=EncoderConfig(
        input_dim=MELS, d_model=D, vocab_size=V, ctc_hidden_dim=H,
        emformer=EmformerConfig(d_model=D, num_heads=4, ffn_dim=FFN,
                                num_layers=L))), use_silero=False)
    side = _DeviceSide(pickle.dumps(cfg), 0, path, None, "cpu")
    enc_p = side.params["encoder"]
    np.testing.assert_array_equal(enc_p["ctc"]["w2"].numpy(),
                                  dec["linear2.weight"].numpy().T)
    np.testing.assert_array_equal(
        enc_p["emformer"]["ff_w1"][1].numpy(),
        enc["encoder_layers.emformer_layers.1.pos_ff.1.weight"].numpy().T)


def test_speaker_wav_builds_a_verifier(tmp_path):
    """``speaker_wav`` with ``speaker_weights`` as a speechbrain .ckpt:
    build_server hands StreamingServer a full-width SpeakerVerifier on
    the device it was given, and logs that device."""
    import logging
    import wave

    import numpy as np
    import torch

    from asr_streaming_tpu_torch.models.ecapa import (
        EcapaConfig, SpeakerVerifier,
    )
    from tests.test_ecapa_convert import synthetic_state_dict
    from asr_streaming_tpu.models.ecapa import EcapaConfig as JEcapaConfig

    wav = str(tmp_path / "enrolled.wav")
    rng = np.random.default_rng(0)
    with wave.open(wav, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes((rng.standard_normal(24000) * 3000).astype(
            np.int16).tobytes())
    ckpt = str(tmp_path / "embedding_model.ckpt")
    torch.save({"embedding_model." + k: torch.from_numpy(v) for k, v in
                synthetic_state_dict(JEcapaConfig(), seed=2).items()}, ckpt)
    settings = _settings(speaker_wav=wav, speaker_weights=ckpt,
                         device_worker=False)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger().addHandler(handler)
    old_level = logging.getLogger().level
    logging.getLogger().setLevel(logging.INFO)
    try:
        server = build_server(settings, max_slots=2, device="cpu")
    finally:
        logging.getLogger().removeHandler(handler)
        logging.getLogger().setLevel(old_level)
    try:
        v = server.speaker_verifier
        assert isinstance(v, SpeakerVerifier)
        assert v.cfg == EcapaConfig() and v.device.type == "cpu"
        assert v.threshold == settings.speaker_threshold
        assert v(np.zeros(0, np.float32)) is False
        assert isinstance(v(rng.standard_normal(8000).astype(np.float32)),
                          bool)
    finally:
        server.scheduler.close()
    msgs = [r.getMessage() for r in records]
    assert any(m.startswith("speaker verifier on cpu") for m in msgs), msgs


def test_no_cuda_no_silent_cpu_fallback(tmp_path):
    """Without a card the entry point raises unless the caller names the
    CPU: build_server's default device, and the CLI."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(_settings(device_worker=False), max_slots=2)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "asr_streaming_tpu_torch.server", "--config",
         os.path.join(ROOT, "configs", "server-vi.yaml"), "--port", "0",
         "--allow-random-weights", "--log-dir", str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    refused = subprocess.run(
        [sys.executable, "-m", "asr_streaming_tpu_torch.server", "--config",
         os.path.join(ROOT, "configs", "server-vi.yaml"), "--log-dir",
         str(tmp_path)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert refused.returncode == 2 and "--allow-random-weights" in \
        refused.stderr
