"""The port stands alone: no jax, nothing of asr_streaming_tpu."""

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
             if m == "jax" or m.startswith("jax.")
             or m == "asr_streaming_tpu" or m.startswith("asr_streaming_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_sources_name_no_jax_import():
    """A static check beside the runtime one: no import line of the port
    or of chip_smoke.py names jax or the JAX package."""
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "asr_streaming_tpu_torch")):
        paths += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for p in paths:
        with open(p) as f:
            for i, line in enumerate(f, 1):
                s = line.strip()
                if s.startswith(("import ", "from ")):
                    mod = s.split()[1]
                    assert not (mod == "jax" or mod.startswith("jax.")
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


def test_device_worker_child_imports_neither():
    """The spawned worker child reports its loaded modules: none of jax or
    the JAX package."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _WORKER_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
