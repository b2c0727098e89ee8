"""The port's native host codec (utils/codec_native.py) and its gather.

The port builds ``native/audio/mulaw.cc`` with the g++ on PATH into its
``_build/``.  Its encoders must equal the numpy LUT (models/serving.py)
and the JAX package's ``codec_native`` bit for bit: mu-law, int16, and
the fused gather over ragged stream views.  The gather's row pool takes
one caller at a time, so calls from many threads at once must still give
exact rows.  The port's Scheduler gives the same events with the native
gather and with the numpy one (``ASR_NO_FUSED_GATHER``), on the overfit
CTC fixture.  Each test skips only when there is no g++.

The JAX package's wrappers are held to the port from a private build of
their library (``jax_codec``): ``asr_streaming_tpu/utils/codec_native.py``
runs ``make`` into ``native/audio/`` when the library is absent and loads
whatever file it finds there, so test processes that start together on a
fresh tree build and load the same file at once, and one that loses the
race keeps ``native_available() == False`` for good.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import threading

import numpy as np
import pytest

from asr_streaming_tpu.models.serving import mulaw_encode_host as j_mulaw
from asr_streaming_tpu.utils import codec_native as jcodec
from asr_streaming_tpu_torch.models.asr import ASRConfig
from asr_streaming_tpu_torch.models.serving import (
    ServingConfig, init_serving_params, mulaw_encode_host,
)
from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
from asr_streaming_tpu_torch.streaming.scheduler import Scheduler
from asr_streaming_tpu_torch.utils import codec_native
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, overlay_params,
)
from tests.test_torch_asr import FIXTURE, golden_and_params, sentence_audio

EDGE = np.array([-2.0, 2.0, -1.0, 1.0, 0.0, -0.0, 1e-8, -1e-8, np.inf,
                 -np.inf, 0.5, -0.5, 0.9999, -0.9999, 1 / 32767, -1 / 32767,
                 0.1, -0.3, 0.7734, 0.25, -0.125, 3e-5, -3e-5], np.float32)


JAX_NATIVE_DIR = os.path.dirname(os.path.abspath(jcodec._LIB_PATH))
JAX_SOURCES = ("Makefile", "mulaw.cc")


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native codec cannot be built")
    assert codec_native.native_available()


@pytest.fixture(scope="module")
def jax_codec_build(tmp_path_factory):
    """The JAX package's codec library built from copies of its Makefile
    and source in a directory of this module's own (``CXX=g++``, as the
    port builds: the card machine's ``$CXX`` links libstdc++ statically),
    never into ``native/audio/``.  Returns (directory, library path)."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native codec cannot be built")
    d = tmp_path_factory.mktemp("jax_codec")
    for name in JAX_SOURCES:
        shutil.copyfile(os.path.join(JAX_NATIVE_DIR, name), d / name)
    subprocess.run(["make", "-C", str(d), "CXX=g++"], check=True,
                   capture_output=True, timeout=300)
    return d, str(d / os.path.basename(jcodec._LIB_PATH))


@pytest.fixture
def jax_codec(jax_codec_build, monkeypatch):
    """``asr_streaming_tpu.utils.codec_native`` pointed at the private
    build for one test: its library path, and its load latch reset so that
    it loads that file; monkeypatch restores all three afterwards."""
    monkeypatch.setattr(jcodec, "_LIB_PATH", jax_codec_build[1])
    monkeypatch.setattr(jcodec, "_lib", None)
    monkeypatch.setattr(jcodec, "_tried", False)
    return jcodec


def _pcm16_numpy(x):
    return np.clip(x * 32767.0, -32768, 32767).astype(np.int16)


def _samples(case):
    rng = np.random.default_rng(0)
    if case == "edge":
        return EDGE[None]
    # an odd row length exercises the scalar tail after the vector loop
    x = rng.standard_normal((33, 1001)).astype(np.float32) * 0.6
    x[0, :4] = [-2.0, 2.0, 1.0, -1.0]
    return x


def _rows_through_gather(x, mulaw):
    """Each row of ``x`` encoded by the port's gather into its own row."""
    out = np.zeros(x.shape, np.uint8 if mulaw else np.int16)
    slots = np.arange(x.shape[0], dtype=np.int32)
    assert codec_native.gather_encode_into(list(x), slots, out, mulaw)
    return out


@pytest.mark.parametrize("case", ["random", "edge"])
def test_mulaw_bit_exact_vs_numpy_and_jax(case, jax_codec):
    _need_gxx()
    x = _samples(case)
    out = _rows_through_gather(x, True)
    np.testing.assert_array_equal(out, mulaw_encode_host(x))
    np.testing.assert_array_equal(out, j_mulaw(x))
    assert jax_codec.native_available()
    ref = np.zeros(x.shape, np.uint8)
    assert jax_codec.mulaw_encode_into(x, ref)
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("case", ["random", "edge"])
def test_pcm16_bit_exact_vs_numpy_and_jax(case, jax_codec):
    _need_gxx()
    x = _samples(case)
    out = _rows_through_gather(x, False)
    np.testing.assert_array_equal(out, _pcm16_numpy(x))
    ref = np.zeros(x.shape, np.int16)
    assert jax_codec.pcm16_encode_into(x, ref)
    np.testing.assert_array_equal(out, ref)


def test_gather_refuses_what_the_native_loop_cannot_check():
    _need_gxx()
    views = [np.zeros(8, np.float32)] * 2
    out = np.zeros((4, 8), np.uint8)
    bad = [
        (views, np.array([0, 4], np.int32), out, True),       # slot range
        (views, np.array([0, 1], np.int64), out, True),       # slot dtype
        (views, np.array([0, 1], np.int32), out, False),      # out dtype
        (views, np.array([0, 1], np.int32), out[:, ::2], True),
        ([np.zeros(7, np.float32)] * 2, np.array([0, 1], np.int32), out,
         True),                                              # view length
        ([np.zeros(16, np.float32)[::2]] * 2, np.array([0, 1], np.int32),
         out, True),                                         # strided view
    ]
    for args in bad:
        with pytest.raises(ValueError):
            codec_native.gather_encode_into(*args)


def test_jax_codec_comes_from_the_private_build(jax_codec_build, jax_codec):
    """The library the JAX wrappers load in these tests is the fixture's:
    built in its own directory from byte-equal copies of
    ``native/audio/``'s Makefile and source, and not a file of
    ``native/audio/``."""
    d, path = jax_codec_build
    for name in JAX_SOURCES:
        with open(os.path.join(JAX_NATIVE_DIR, name), "rb") as a, \
                open(d / name, "rb") as b:
            assert a.read() == b.read(), name
    assert os.path.dirname(path) == str(d)
    assert os.path.commonpath([path, JAX_NATIVE_DIR]) != JAX_NATIVE_DIR
    assert os.path.isfile(path)
    assert jax_codec.native_available()
    lib = jax_codec._lib
    assert isinstance(lib, ctypes.CDLL)
    assert os.path.samefile(lib._name, path)


def _ragged_views(rng, rows, cols):
    """Stream-like views: each a slice at its own offset of its own ring
    buffer, as Stream.pop_chunk_view returns them."""
    views = []
    for i in range(rows):
        buf = (rng.standard_normal(cols + 37 * i + 5) * 0.5
               ).astype(np.float32)
        buf[3] = 2.0 if i % 2 else -2.0
        off = (11 * i) % (37 * i + 6)
        views.append(buf[off:off + cols])
    return views


@pytest.mark.parametrize("mulaw", [True, False], ids=["mulaw", "pcm16"])
@pytest.mark.parametrize("rows", [1, 5, 40])
def test_gather_ragged_views_bit_exact(mulaw, rows, jax_codec):
    """Row i encodes views[i] into out[slots[i]]; rows not named keep
    their bytes; the JAX package's gather writes the same matrix."""
    _need_gxx()
    rng = np.random.default_rng(rows)
    slots_total, cols = 48, 1000
    views = _ragged_views(rng, rows, cols)
    slots = rng.permutation(slots_total)[:rows].astype(np.int32)
    dtype = np.uint8 if mulaw else np.int16
    out = np.full((slots_total, cols), 9, dtype)
    ref = out.copy()
    assert codec_native.gather_encode_into(views, slots, out, mulaw)
    assert jax_codec.gather_encode_into(views, slots, ref, mulaw)
    np.testing.assert_array_equal(out, ref)
    want = np.full((slots_total, cols), 9, dtype)
    for i, slot in enumerate(slots):
        want[slot] = (mulaw_encode_host(views[i][None])[0] if mulaw
                      else _pcm16_numpy(views[i]))
    np.testing.assert_array_equal(out, want)


def test_gather_from_many_threads_stays_exact():
    """The library's row pool takes one caller (RowPool::Run is not
    reentrant): concurrent gathers from more threads than cores, as a
    GroupedScheduler's groups and a server's tick thread may make, each
    still get exact rows."""
    _need_gxx()
    rng = np.random.default_rng(7)
    jobs = []
    for k in range(2 * (os.cpu_count() or 4)):
        views = _ragged_views(rng, 32, 640)
        want = np.stack([mulaw_encode_host(v[None])[0] for v in views])
        jobs.append((views, want))
    errors = []

    def run(views, want):
        out = np.zeros((32, 640), np.uint8)
        slots = np.arange(32, dtype=np.int32)
        for _ in range(20):
            out[:] = 0
            codec_native.gather_encode_into(views, slots, out, True)
            if not np.array_equal(out, want):
                errors.append("mismatch")
                return

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=job) for job in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors


def test_library_builds_into_the_port_build_dir():
    _need_gxx()
    path = codec_native.build()
    assert path == codec_native.library_path()
    assert os.path.dirname(path) == codec_native.BUILD_DIR
    assert os.path.basename(path).startswith("libasrcodec_")


@pytest.mark.parametrize("encoding", ["mulaw", "int16"])
def test_scheduler_native_and_numpy_gather_same_events(encoding,
                                                       monkeypatch):
    """The overfit fixture's streams through the port's Scheduler: the
    native fused gather and the numpy gather give the same events, and
    stats() names the encoder that ran."""
    _need_gxx()
    monkeypatch.setenv("ASR_NO_ASYNC_HARVEST", "1")
    golden, _ = golden_and_params()
    one = sentence_audio(golden, total=3.84)
    audio = [one, np.concatenate([np.zeros(10240, np.float32), one]),
             np.concatenate([one, one])]
    cfg = ServingConfig(asr=ASRConfig.tiny(vocab_size=6), use_silero=False,
                        use_energy_gate=False, energy_threshold_db=-200.0,
                        upload_encoding=encoding)
    params = overlay_params(init_serving_params(1, cfg, "cpu"),
                            load_params(FIXTURE))
    rules = {"r": EndpointRule(must_contain_nonsilence=True,
                               min_trailing_silence=0.8,
                               min_utterance_length=0.0,
                               max_relative_cost=float("inf"))}

    def run(numpy_gather):
        if numpy_gather:
            monkeypatch.setenv("ASR_NO_FUSED_GATHER", "1")
        else:
            monkeypatch.delenv("ASR_NO_FUSED_GATHER", raising=False)
        sched = Scheduler(params, cfg, ["-", "|", "a", "b", "c", "d"],
                          max_slots=4, rules=rules, device="cpu")
        streams = [sched.admit(f"s{i}") for i in range(len(audio))]
        for s, a in zip(streams, audio):
            s.accept_waveform(a)
            s.add_tail_padding()
        events = [(e.stream_id, e.kind, e.text) for e in sched.drain()]
        encoder = sched.stats()["gather_encoder"]
        sched.close()
        return events, encoder

    native, enc_native = run(False)
    numpy_, enc_numpy = run(True)
    assert (enc_native, enc_numpy) == ("native", "numpy")
    assert native == numpy_
    assert golden in [text for _, kind, text in native if kind == "final"]
