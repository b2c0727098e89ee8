"""The port's server config loader and startup checks.

``ServerSettings.load`` of the port equals the JAX package's, field by
field as plain data, on every shipped config and on the reference-layout
file, with one intended difference: a flat ``endpoint_rules`` also
replaces ``endpoint_rulesets["DEFAULT"]``, so ``Stream`` serves it (the
JAX loader loses it when the file also has ``Endpointing_rules``).
``build_server`` hands ``quant`` to the device-worker child inside the
pickled config, raises on settings of a later slice, and never falls back
to the CPU.
"""

import dataclasses
import glob
import os
import subprocess
import sys

import pytest

from asr_streaming_tpu.server.config import ServerSettings as JSettings
from asr_streaming_tpu_torch.server.__main__ import build_server
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
    (dict(speaker_wav="enrolled.wav"), "item 3"),
    (dict(checkpoint="asr-online.ckpt"), "item 5"),
    (dict(data_parallel=0), "item 4"),
], ids=["speaker_wav", "ckpt", "data_parallel"])
def test_later_slice_settings_raise_naming_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        build_server(_settings(**kw), max_slots=2, device="cpu")


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
