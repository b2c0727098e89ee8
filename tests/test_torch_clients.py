"""The port's clients and frame VAD.

The clients (``client/{asr_client,dual_client,load_test}.py``, copies of
the JAX package's) drive the port's websocket server serving the trained
CTC fixture at the tiny geometry on a loopback port: the finals carry the
fixture's golden sentence, and equal what the JAX package's own client
reads from the same server.  ``merge_bilingual`` takes tests/test_client.py's
cases.  The frame VAD (``models/frame_vad.py``), built from
``native/vad/frame_vad.cc`` into the port's ``_build/`` with the g++ on
PATH, decides every frame as the JAX package's ``FrameVad`` does, at each
aggressiveness.
"""

import asyncio
import os
import subprocess
import sys
import wave as wave_mod

import numpy as np
import pytest

from asr_streaming_tpu.client import asr_client as j_client
from asr_streaming_tpu.client import dual_client as j_dual
from asr_streaming_tpu.models.frame_vad import FrameVad as JFrameVad
from asr_streaming_tpu_torch.client import asr_client, dual_client, load_test
from asr_streaming_tpu_torch.models import frame_vad
from asr_streaming_tpu_torch.server.ws_server import StreamingServer
from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
from asr_streaming_tpu_torch.utils import native_build
from tests.torch_train_common import one_torch_thread  # noqa: F401
from tests.test_torch_server import (
    CTC_HZ, CTC_VOCAB, RULES, URL, Running, _ctc_setup, _pcm, _tones,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served():
    golden, cfg, params = _ctc_setup()
    sched = Scheduler(params, cfg, CTC_VOCAB, max_slots=3, rules=RULES,
                      device="cpu")
    st = Running(StreamingServer(sched, tick_idle_sleep=0.002))
    pcm = _pcm(_tones(golden, 3.84, CTC_HZ))
    yield golden, st, f"ws://127.0.0.1:{st.port}" + URL.format(rate=16000), \
        pcm
    st.close()


def _texts(result):
    return [f["result"]["hypotheses"][0]["transcript"].strip()
            for f in result.finals]


def test_stream_audio_serves_the_golden_as_the_jax_client_reads_it(served):
    golden, _, url, pcm = served
    got = asyncio.run(asr_client.stream_audio(
        url, pcm.tobytes(), realtime=False, request_id="cli-1"))
    assert got.completed and got.partials
    assert got.first_partial_latency is not None
    assert {f["id"] for f in got.finals} == {"cli-1"}
    assert golden in _texts(got)
    assert got.transcript == " ".join(t for t in _texts(got)).strip()
    want = asyncio.run(j_client.stream_audio(
        url, pcm.tobytes(), realtime=False, request_id="cli-1"))
    assert _texts(got) == _texts(want)


def test_load_pcm_equals_the_jax_one(tmp_path):
    """A stereo 8 kHz wav: channel 0, resampled to 16 kHz."""
    rng = np.random.default_rng(0)
    pcm = (rng.standard_normal((4000, 2)) * 3000).astype(np.int16)
    path = str(tmp_path / "x.wav")
    with wave_mod.open(path, "wb") as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(8000)
        f.writeframes(pcm.tobytes())
    got = asr_client.load_pcm(path)
    assert got == j_client.load_pcm(path) and len(got) == 2 * 8000


def test_load_test_summary(served):
    golden, _, url, pcm = served
    report = asyncio.run(load_test.run_load(url, pcm.tobytes(), 2,
                                            ramp_seconds=0.2,
                                            chunks_per_second=16))
    assert set(report) == {
        "streams_requested", "streams_completed", "errors",
        "audio_seconds_per_stream", "wall_seconds", "rtf",
        "first_partial_p50_s", "first_partial_p95_s", "finals_per_stream"}
    assert (report["streams_requested"], report["streams_completed"],
            report["errors"]) == (2, 2, 0)
    assert report["audio_seconds_per_stream"] == 3.84
    assert report["finals_per_stream"] >= 1
    assert 0 < report["first_partial_p50_s"] <= report["first_partial_p95_s"]


def test_client_clis_run_as_modules(served, tmp_path):
    golden, _, url, pcm = served
    path = str(tmp_path / "golden.wav")
    with wave_mod.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(16000)
        f.writeframes(pcm.tobytes())
    env = {**os.environ, "PYTHONPATH": REPO}
    for args, mark in (
            (["asr_client", path, "--url", url, "--no-realtime"],
             "FINAL:"),
            (["dual_client", path, "--vi-url", url, "--no-realtime"],
             "--- merged ---")):
        out = subprocess.run(
            [sys.executable, "-m", "asr_streaming_tpu_torch.client." + args[0],
             *args[1:]], capture_output=True, text=True, timeout=120,
            env=env, cwd=tmp_path)
        assert out.returncode == 0, out.stderr[-3000:]
        assert golden in out.stdout and mark in out.stdout, out.stdout


def test_merge_bilingual_prefers_confidence():
    """tests/test_client.py's cases, and the JAX merge on the same."""
    MS = dual_client.MergedSegment
    vi = [MS(0.0, 2.0, "xin chao", "vi", 0.6),
          MS(2.5, 4.0, "tam biet", "vi", 0.9)]
    en = [MS(0.1, 1.9, "hello", "en", 0.8),
          MS(5.0, 6.0, "goodbye", "en", 0.7)]
    merged = dual_client.merge_bilingual(vi, en)
    assert [m.text for m in merged] == ["hello", "tam biet", "goodbye"]
    vi2 = [MS(0.0, 2.0, "a", "vi", 0.8)]
    en2 = [MS(0.0, 2.0, "b", "en", 0.8)]
    assert dual_client.merge_bilingual(vi2, en2)[0].text == "a"

    def jax_side(segs):
        return [j_dual.MergedSegment(**vars(s)) for s in segs]
    for a, b in ((vi, en), (vi2, en2), (en, vi)):
        want = j_dual.merge_bilingual(jax_side(a), jax_side(b))
        assert [vars(m) for m in dual_client.merge_bilingual(a, b)] == \
            [vars(m) for m in want]
    for text in ("xin chào", "hello world", "", "123 ?"):
        assert dual_client.detect_language(text) == \
            j_dual.detect_language(text)


def _vad_audio():
    """Silence, quiet noise, tones and a speech-shaped AM carrier
    (tests/test_frame_vad.py's signals), 16 kHz."""
    rng = np.random.default_rng(7)
    t = np.arange(32000) / 16000
    am = 0.5 * (1 + np.sin(2 * np.pi * 4 * t))
    parts = [np.zeros(8000),
             rng.standard_normal(16000) * 0.001,
             0.4 * np.sin(2 * np.pi * 300 * t[:16000]),
             0.3 * am * np.sin(2 * np.pi * 220 * t)
             + 0.01 * rng.standard_normal(len(t)),
             rng.standard_normal(16000) * 0.05,
             0.5 * np.sin(2 * np.pi * 500 * t[:8000])]
    return np.concatenate(parts).astype(np.float32)


@pytest.mark.parametrize("rate,ms", [(16000, 30), (8000, 10), (16000, 20)])
def test_frame_vad_decides_every_frame_as_the_jax_one(rate, ms):
    audio = _vad_audio()[::16000 // rate]
    n = rate * ms // 1000
    pcm = (np.clip(audio, -1, 1) * 32767).astype(np.int16)
    frames = [pcm[i:i + n].tobytes() for i in range(0, len(pcm) - n + 1, n)]
    counts = []
    for mode in range(4):
        got, want = frame_vad.FrameVad(mode), JFrameVad(mode)
        decisions = [got.is_speech(f, rate) for f in frames]
        assert decisions == [want.is_speech(f, rate) for f in frames], mode
        counts.append(sum(decisions))
        assert got.contains_speech(audio, rate, ms) == \
            want.contains_speech(audio, rate, ms)
    assert 0 < counts[3] <= counts[0] < len(frames)


def test_frame_vad_builds_from_source_into_the_port():
    frame_vad.FrameVad(2)
    path = frame_vad.library_path()
    assert os.path.dirname(path) == native_build.BUILD_DIR
    assert os.path.basename(path).startswith("libframevad_")
    assert frame_vad._lib._name == path
    vad = frame_vad.FrameVad(2)
    with pytest.raises(ValueError):
        vad.is_speech(b"\x00" * 123, 16000)
    with pytest.raises(ValueError):
        vad.is_speech(b"\x00" * 960, 44100)
    with pytest.raises(ValueError):
        frame_vad.FrameVad(7)


def test_frame_vad_raises_without_a_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(frame_vad, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native_build, "compiler", lambda: None)
    with pytest.raises(RuntimeError, match="no g\\+\\+ on PATH"):
        frame_vad.FrameVad(2)
