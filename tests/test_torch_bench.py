"""The port's bench (python -m asr_streaming_tpu_torch.bench) on the CPU.

Its copy of ``model_paced_trace`` equals bench.py's on the inputs of
tests/test_bench_model.py; its three phases run at ``ASRConfig.tiny`` with
8 slots in 2 groups and short windows on the plain versions
(``device="cpu"``) and give one JSON line with every key; without a
device named it raises on a machine without CUDA.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from asr_streaming_tpu_torch.bench import model_paced_trace, run_bench
from asr_streaming_tpu_torch.models.asr import ASRConfig
from bench import model_paced_trace as j_model_paced_trace
# torch on one thread: in the six-worker tier-1 run, the bench phases'
# eight-thread ticks on an oversubscribed host ran 50x slower than alone
# and the paced window could end with no event
from tests.torch_train_common import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# tests/test_bench_model.py's inputs
TRACE_CASES = ([(ms / 1e3, 512, 2, 10.0, 0.64) for ms in (5.0, 12.0, 25.0,
                                                          60.0)]
               + [(0.02, 512, 2, 10.0, 0.64), (0.02, 256, 1, 5.0, 0.64)])

EXTRA_KEYS = (
    "full_service_round_ms", "paced_p50_ms", "paced_p95_ms",
    "paced_wait_p50_ms", "paced_service_p50_ms", "modeled_p50_ms",
    "device_exec_ms", "gather_host_p50_ms", "scatter_host_p50_ms",
    "pcie_tick_ms", "stage_p50_ms", "windows", "route", "gather_encoder",
    "weights_mode", "max_memory_allocated", "device")


@pytest.mark.parametrize("args", TRACE_CASES, ids=str)
def test_model_paced_trace_equals_bench_py(args):
    assert model_paced_trace(*args) == j_model_paced_trace(*args)


def test_phases_run_on_the_cpu_and_print_one_json_line(capsys):
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native gather cannot be built")
    result = run_bench("cpu", asr_cfg=ASRConfig.tiny(), slots=8, groups=2,
                       passes_a=1, passes_b=1, seconds_a=1.0,
                       seconds_b=1.3, exec_reps=2)
    print(json.dumps(result))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "concurrent_rtf1_streams_per_chip"
    # the tiny model on a loaded CPU may keep fewer than one stream at
    # real time, so the value may round down to 0; chunks must flow
    assert out["unit"] == "streams" and out["value"] >= 0
    assert out["vs_baseline"] == round(out["value"] / 500.0, 3)
    extra = out["extra"]
    missing = [k for k in EXTRA_KEYS if k not in extra]
    assert not missing, missing
    assert extra["gather_encoder"] == "native"
    assert extra["route"] == "stack" and extra["use_silero"] is True
    assert extra["upload_encoding"] == "mulaw"
    assert extra["weights_mode"].startswith("trained-vad-fixture")
    assert extra["device"] == {"name": "cpu", "power_limit": None}
    assert extra["pcie_tick_ms"] == pytest.approx(
        extra["device_exec_ms"] + extra["gather_host_p50_ms"]
        + extra["scatter_host_p50_ms"], abs=1e-3)
    assert extra["paced_p50_ms"] > 0 and extra["device_exec_ms"] > 0
    windows = extra["windows"]
    assert len(windows["throughput"]) == 1 and len(windows["paced"]) == 1
    assert windows["throughput"][0]["chunks"] > 0
    assert windows["paced"][0]["samples"] > 0


def test_no_device_named_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_bench(asr_cfg=ASRConfig.tiny(), slots=2, groups=1)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "asr_streaming_tpu_torch.bench"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""
