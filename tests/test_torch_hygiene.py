"""The port stands alone: no jax, no optax, nothing of
asr_streaming_tpu."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import asr_streaming_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "optax") or m.startswith(("jax.", "optax."))
             or m == "asr_streaming_tpu" or m.startswith("asr_streaming_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 50, names
for new in ("models.rnnt", "models.rnnt_beam", "ops.topk", "ops.row_topk",
            "server.__main__", "server.config", "server.ws_server",
            "server.protocol", "server.http_static", "decode.beam",
            "decode.beam_native", "decode.kenlm_binary", "decode.kenlm_trie",
            "text.corpus", "text.spm", "tools.onnx_weights", "utils.logs",
            "utils.noise", "utils.resample", "bench", "models.ecapa",
            "utils.codec_native", "tools.convert_checkpoint",
            "tools.convert_rnnt_checkpoint", "tools.convert_ecapa",
            "parallel.mesh", "parallel.serving", "models.api",
            "models.segmenter", "decode.alignment", "text.tokenizer",
            "tools.transcribe", "tools.evaluate", "tools.profile_beam",
            "ops.sequence", "train.losses", "train.optim", "train.data",
            "train.augment", "train.ctc", "train.run", "train.rnnt",
            "train.vad", "train.speaker", "models.blocks", "models.offline",
            "models.tts", "models.discriminators", "ops.istft", "train.ssl",
            "train.gan", "tools.make_tts_manifest", "text.ngram_lm",
            "text.oov", "parallel.collectives", "train.dist_check",
            "client.asr_client", "client.dual_client", "client.load_test",
            "models.frame_vad", "server.web_gateway", "server.grpc_master",
            "utils.native_build"):
    assert "asr_streaming_tpu_torch." + new in names, new
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_import():
    """A static check beside the runtime one: no import line of the port
    or of chip_smoke.py names jax, optax or the JAX package."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "asr_streaming_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert not (mod in ("jax", "optax")
                                or mod.startswith(("jax.", "optax."))
                                or mod == "asr_streaming_tpu"
                                or mod.startswith("asr_streaming_tpu.")), \
                        f"{p}:{i}: {s}"


_WORKER_PROBE = r"""
from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.serving import ServingConfig
from asr_streaming_tpu_torch.streaming.device_worker import DeviceWorkerClient
cfg = ServingConfig(asr=ASRConfig.tiny(), use_silero=False)
client = DeviceWorkerClient(cfg, 2, device="cpu")
try:
    client.warmup(timeout=120)
    stats = client.stats()
finally:
    client.close()
print(stats["foreign_modules"])
assert stats["foreign_modules"] == [], stats["foreign_modules"]
"""


_EN_WORKER_PROBE = r"""
import dataclasses
from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.rnnt import RNNTConfig
from asr_streaming_tpu_torch.models.serving import ServingConfig
from asr_streaming_tpu_torch.streaming.device_worker import DeviceWorkerClient
from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
cfg = ServingConfig(asr=dataclasses.replace(ASRConfig.tiny(), audio=EN_AUDIO),
                    model_kind="rnnt", rnnt=RNNTConfig.tiny(),
                    use_silero=False, en_beam_width_device=2, en_beam_cap=8)
client = DeviceWorkerClient(cfg, 2, device="cpu")
try:
    client.warmup(timeout=120)
    stats = client.stats()
finally:
    client.close()
print(stats["foreign_modules"])
assert stats["foreign_modules"] == [], stats["foreign_modules"]
assert "row_topk" in stats["launches"], stats["launches"]
"""


def _run_probe(probe):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_device_worker_child_imports_neither():
    """The spawned worker child reports its loaded modules: none of jax or
    the JAX package."""
    _run_probe(_WORKER_PROBE)


def test_en_device_worker_child_imports_neither():
    """The same for a child that serves the English beam tick."""
    _run_probe(_EN_WORKER_PROBE)
