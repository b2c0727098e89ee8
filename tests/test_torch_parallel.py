"""The port's multi-GPU serving (parallel/) on CPU shards.

The sharded step on n = 1, 2, 4 and 8 CPU shards equals the unsharded
step bit for bit (every shard runs the same plain code on its own rows,
which share no sum), for the Vietnamese CTC tick and both English ticks,
over chained ticks with reset, hold, a new stream and a silent slot.
Against the JAX package's ``make_sharded_stepper`` on its virtual
8-device CPU mesh, with the weights carried across: pack flags and
token / argmax columns and the integer state exact, floats within
rtol = atol = 2e-5 (f32 compute); the float16 encoding buffer within
rtol 2e-3 (two f16 steps: values 2e-5 apart can round to neighbouring
f16 values), as tests/test_torch_serving_rnnt.py holds it.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from asr_streaming_tpu.models import asr as ja
from asr_streaming_tpu.models import rnnt as jr
from asr_streaming_tpu.models import serving as js
from asr_streaming_tpu.parallel import serving as jps
from asr_streaming_tpu.streaming.endpoint import EndpointRule as JEndpointRule
from asr_streaming_tpu.streaming.scheduler import Scheduler as JScheduler
from asr_streaming_tpu.utils.audio import EN_AUDIO as J_EN_AUDIO
from asr_streaming_tpu_torch.models import asr as ta
from asr_streaming_tpu_torch.models import rnnt as tr
from asr_streaming_tpu_torch.models import serving as ts
from asr_streaming_tpu_torch.parallel import serving as tps
from asr_streaming_tpu_torch.parallel.mesh import DeviceMesh, make_mesh
from asr_streaming_tpu_torch.streaming.endpoint import EndpointRule
from asr_streaming_tpu_torch.streaming.scheduler import (
    GroupedScheduler, Scheduler,
)
from asr_streaming_tpu_torch.utils.audio import EN_AUDIO
from asr_streaming_tpu_torch.utils.checkpoint import (
    load_params, params_from_numpy,
)
from tests.test_torch_asr import FIXTURE, golden_and_params, sentence_audio
from tests.test_torch_scheduler import TONE_VOCAB, TRAINED_RULE
from tests.torch_train_common import synchronous

# 16 slots: every shard of the n = 8 split holds 2 rows.  A 1-row shard
# takes the CPU's matrix-vector path, which sums in another order than
# the matrix-matrix one, so its floats would differ in the last bits.
B = 16
N_TICKS = 3
TOL = dict(rtol=2e-5, atol=2e-5)
KINDS = ("vi", "en_greedy", "en_beam")


def _configs(kind):
    if kind == "vi":
        kw = dict(use_silero=False, max_emission_frames=64)
        return (js.ServingConfig(asr=ja.ASRConfig.tiny(vocab_size=21), **kw),
                ts.ServingConfig(asr=ta.ASRConfig.tiny(vocab_size=21), **kw))
    kw = dict(model_kind="rnnt", use_silero=False, max_emission_frames=32,
              en_beam_width_device=4 if kind == "en_beam" else None,
              en_beam_cap=24)
    return (js.ServingConfig(
                asr=dataclasses.replace(ja.ASRConfig.tiny(),
                                        audio=J_EN_AUDIO),
                rnnt=jr.RNNTConfig.tiny(vocab_size=32), **kw),
            ts.ServingConfig(
                asr=dataclasses.replace(ta.ASRConfig.tiny(), audio=EN_AUDIO),
                rnnt=tr.RNNTConfig.tiny(vocab_size=32), **kw))


def _inputs(tcfg):
    """N_TICKS of (segment, contain, active, new_stream, reset) for B
    slots: slot 1 silent, slot 2 held on tick 1, slot 5 a new stream on
    tick 2, slot 3 reset on tick 2."""
    rng = np.random.default_rng(4)
    seg_len = tcfg.asr.audio.segment_length
    levels = np.tile(np.array([0.3, 0.0, 0.05, 0.3, 0.2, 0.3, 0.1, 0.3],
                              np.float32), B // 8)
    ticks = []
    for t in range(N_TICKS):
        audio = rng.standard_normal((B, seg_len)) * levels[:, None]
        seg = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
        contain = rng.random(B) < 0.3
        active = np.ones(B, bool)
        active[2] = t != 1
        new_stream = np.full(B, t == 0)
        new_stream[5] |= t == 2
        reset = new_stream.copy()
        reset[3] |= t == 2
        ticks.append((seg, contain, active, new_stream, reset))
    return ticks


@pytest.fixture(scope="module")
def setups():
    """{kind: (jcfg, tcfg, jax params, port params, inputs)}."""
    out = {}
    for kind in KINDS:
        jcfg, tcfg = _configs(kind)
        jparams = js.init_serving_params(jax.random.PRNGKey(3), jcfg)
        tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
        out[kind] = (jcfg, tcfg, jparams, tparams, _inputs(tcfg))
    return out


def _port_run(tcfg, tparams, ticks, n=None):
    """The port's ticks unsharded (n None) or on n CPU shards: per tick
    (pack, state, ctx, emission), the sharded ones joined in slot order."""
    if n is None:
        step = ts.make_serving_step(tcfg)
        args = (tparams,)
        state = ts.init_serving_state(tcfg, B, "cpu")
        ctx = ts.init_audio_context(tcfg, B, "cpu")
        em = ts.init_emission_buffer(tcfg, B, "cpu")
    else:
        mesh = tps.make_serving_mesh(n, device="cpu")
        step = tps.make_sharded_stepper(tcfg, mesh, tparams)
        args = (step.params,)
        state, ctx, em = tps.shard_serving_arrays(
            tcfg, mesh, ts.init_serving_state(tcfg, B, "cpu"),
            ts.init_audio_context(tcfg, B, "cpu"),
            ts.init_emission_buffer(tcfg, B, "cpu"))
    axes = tps.serving_state_slot_axes(tcfg)
    outs = []
    for tick in ticks:
        host = [torch.from_numpy(x) for x in tick]
        if n is not None:
            host = [tps.split_rows(x, mesh) for x in host]
        o = step(*args, tcfg, *host, state, ctx, em)
        state, ctx, em = o.state, o.ctx, o.emission
        if n is None:
            outs.append((o.pack.clone(), o.state, o.ctx, o.emission.clone()))
        else:
            outs.append((tps.join_shards(o.pack, 0),
                         tps.join_shards(o.state, axes),
                         tps.join_shards(o.ctx, 0),
                         tps.join_shards(o.emission, 0)))
    return outs


@pytest.fixture(scope="module")
def unsharded(setups):
    return {kind: _port_run(s[1], s[3], s[4]) for kind, s in setups.items()}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_sharded_step_equals_unsharded_bit_for_bit(setups, unsharded, kind,
                                                   n):
    _, tcfg, _, tparams, ticks = setups[kind]
    got = _port_run(tcfg, tparams, ticks, n)
    for t, (g, w) in enumerate(zip(got, unsharded[kind])):
        pack, state, ctx, em = g
        wpack, wstate, wctx, wem = w
        assert torch.equal(pack, wpack), f"pack tick {t}"
        assert torch.equal(ctx, wctx), f"ctx tick {t}"
        assert torch.equal(em, wem), f"emission tick {t}"
        for name, a, b in zip(_fields(state), _flat(state), _flat(wstate)):
            assert torch.equal(a, b), f"{name} tick {t}"
    decoded = torch.stack([g[0][:, ts.PACK_DECODED] > 0.5 for g in got])
    assert decoded.any() and not decoded.all()      # both paths ran


def _flat(state):
    if isinstance(state, tuple):
        return [x for part in state for x in _flat(part)]
    return [state]


def _fields(state, prefix=""):
    if isinstance(state, tuple):
        return [f for name, part in zip(state._fields, state)
                for f in _fields(part, prefix + name + ".")]
    return [prefix.rstrip(".")]


@pytest.mark.parametrize("kind", KINDS)
def test_sharded_step_matches_jax_sharded_stepper(setups, kind):
    jcfg, tcfg, jparams, tparams, ticks = setups[kind]
    mesh = jps.make_serving_mesh(8)
    jstep = jps.make_sharded_stepper(jcfg, mesh, jparams, donate_state=False)
    jstate, jctx, jem = jps.shard_serving_arrays(
        jcfg, mesh, js.init_serving_state(jcfg, B),
        js.init_audio_context(jcfg, B), js.init_emission_buffer(jcfg, B))
    got = _port_run(tcfg, tparams, ticks, 8)
    fetch_j = js.make_emission_fetcher(jcfg)
    fetch_t = ts.make_emission_fetcher(tcfg)
    lengths = np.zeros(B, np.int64)
    U = (tcfg.rnnt.emformer.segment_length if tcfg.model_kind == "rnnt"
         else tcfg.asr.encoder.emformer.segment_length)
    for t, (tick, (pack, state, ctx, em)) in enumerate(zip(ticks, got)):
        jo = jstep(jparams, *(jnp.asarray(x) for x in tick), jstate, jctx,
                   jem)
        jstate, jctx, jem = jo.state, jo.ctx, jo.emission
        jp, tp = np.asarray(jo.pack), pack.numpy()
        np.testing.assert_array_equal(tp[:, :3], jp[:, :3],
                                      err_msg=f"flags tick {t}")
        np.testing.assert_array_equal(tp[:, 5:], jp[:, 5:],
                                      err_msg=f"data tick {t}")
        np.testing.assert_allclose(tp[:, 3:5], jp[:, 3:5], **TOL)
        np.testing.assert_allclose(ctx.numpy(), np.asarray(jctx), **TOL)
        for name, a, b in zip(_fields(state), _flat(state),
                              jax.tree_util.tree_leaves(jstate)):
            if a.dtype == torch.int32:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                              err_msg=f"{name} tick {t}")
            else:
                np.testing.assert_allclose(a.float().numpy(), np.asarray(
                    b, np.float32), err_msg=f"{name} tick {t}", **TOL)
        decoded = tp[:, ts.PACK_DECODED] > 0.5
        lengths = np.where(tick[4], 0, lengths) + U * decoded
    for slot in np.flatnonzero(lengths):
        np.testing.assert_allclose(fetch_t(em, slot, lengths[slot]),
                                   fetch_j(jem, slot, lengths[slot]),
                                   rtol=2e-3, atol=2e-5)


def _events(sched, audio):
    streams = [sched.admit(f"s{i}") for i in range(len(audio))]
    for s, a in zip(streams, audio):
        s.accept_waveform(a)
        s.add_tail_padding()
    return [(e.stream_id, e.kind, e.text) for e in sched.drain()]


def test_scheduler_with_mesh_same_events_as_without_and_as_jax(monkeypatch):
    """The overfit fixture's three streams (trained weights: confident
    argmaxes) through the port's Scheduler with no mesh, with 4 CPU
    shards and as GroupedScheduler(groups=2) on 2 shards, and through the
    JAX scheduler on its 8-device mesh (synchronous harvest, each step
    waited for: ROADMAP fault 13): the same events."""
    monkeypatch.setenv("ASR_NO_ASYNC_HARVEST", "1")
    golden, _ = golden_and_params()
    one = sentence_audio(golden, total=3.84)
    audio = [one, np.concatenate([np.zeros(10240, np.float32), one]),
             np.concatenate([one, one])]
    kw = dict(use_silero=False, use_energy_gate=False,
              energy_threshold_db=-200.0, upload_encoding="mulaw")
    jcfg = js.ServingConfig(asr=ja.ASRConfig.tiny(vocab_size=6), **kw)
    jparams = js.init_serving_params(jax.random.PRNGKey(1), jcfg)
    trained = load_params(FIXTURE)
    jparams["frontend"] = trained["frontend"]
    jparams["encoder"] = trained["encoder"]
    jsched = synchronous(JScheduler(
        jparams, jcfg, TONE_VOCAB, max_slots=8, mesh=jps.make_serving_mesh(8),
        donate_state=False, rules={"r": JEndpointRule(**TRAINED_RULE)}))
    want = _events(jsched, audio)
    jsched.close()
    finals = [text for _, kind, text in want if kind == "final" and text]
    assert golden in finals, want

    tcfg = ts.ServingConfig(asr=ta.ASRConfig.tiny(vocab_size=6), **kw)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    rules = {"r": EndpointRule(**TRAINED_RULE)}
    plain = Scheduler(tparams, tcfg, TONE_VOCAB, max_slots=8, rules=rules,
                      device="cpu")
    sharded = Scheduler(tparams, tcfg, TONE_VOCAB, max_slots=8, rules=rules,
                        mesh=tps.make_serving_mesh(4, device="cpu"))
    assert len(sharded.device_state) == 4
    assert sharded.device_state[0].mem.shape[1] == 2      # slots per shard
    grouped = GroupedScheduler(tparams, tcfg, TONE_VOCAB, max_slots=8,
                               groups=2, rules=rules,
                               mesh=tps.make_serving_mesh(2, device="cpu"))
    # one copy of the weights for every group and shard
    assert grouped.groups[0].params[0] is grouped.groups[1].params[1]
    assert _events(plain, audio) == want
    assert _events(sharded, audio) == want
    got = _events(grouped, audio)
    # groups tick in turn: each stream's events are the same, in order
    for sid in {s for s, _, _ in want}:
        assert [e for e in got if e[0] == sid] == \
            [e for e in want if e[0] == sid]
    for sched in (plain, sharded, grouped):
        sched.close()


def test_mesh_requires_divisible_slots(setups):
    _, tcfg, _, tparams, _ = setups["vi"]
    with pytest.raises(ValueError, match="multiple"):
        Scheduler(tparams, tcfg, ["-"] * 21, max_slots=6,
                  mesh=tps.make_serving_mesh(4, device="cpu"))
    with pytest.raises(ValueError, match="multiple"):
        tps.shard_serving_arrays(
            tcfg, tps.make_serving_mesh(4, device="cpu"),
            ts.init_serving_state(tcfg, 6, "cpu"),
            ts.init_audio_context(tcfg, 6, "cpu"), None)


def test_grouped_scheduler_rounds_group_size_up(setups):
    """groups x data_parallel pairs do not crash: the group size rounds up
    to a multiple of the shards (20 slots, 3 groups, 8 shards: 8 each)."""
    _, tcfg, _, tparams, _ = setups["vi"]
    g = GroupedScheduler(tparams, tcfg, ["-"] * 21, max_slots=20, groups=3,
                         mesh=tps.make_serving_mesh(8, device="cpu"))
    assert [grp.max_slots for grp in g.groups] == [8, 8, 8]
    assert g.max_slots >= 20
    g.close()


def test_make_mesh_and_serving_mesh_shapes():
    cpu = torch.device("cpu")
    mesh = make_mesh(devices=[cpu] * 4)
    assert isinstance(mesh, DeviceMesh) and mesh.devices == (cpu,) * 4
    assert mesh.shape == {"data": 4, "model": 1}
    assert make_mesh(2, devices=["cpu"] * 4).shape["data"] == 2
    assert tps.data_parallel_size(mesh) == 4
    # the training layout: rank i in data row i // 2, model column i % 2
    tp = make_mesh(devices=[cpu] * 4, model_parallel=2)
    assert tp.shape == {"data": 2, "model": 2}
    assert [tp.coords(r) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    assert tps.make_serving_mesh(0, device="cpu").shape["data"] == 8
    with pytest.raises(ValueError, match="chips requested"):
        tps.make_serving_mesh(999, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="chips requested"):
            tps.make_serving_mesh(999)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_replicated_params_one_copy_per_device(setups):
    _, tcfg, _, tparams, _ = setups["vi"]
    reps = tps.replicate_params(tparams, tps.make_serving_mesh(4, "cpu"))
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    w = tparams["encoder"]["emformer"]
    assert next(iter(reps[0]["encoder"]["emformer"].values())) is \
        next(iter(w.values()))                          # no copy on-device
    assert tps.replicate_params(reps, tps.make_serving_mesh(4, "cpu")) \
        is reps


def _capture_schedulers(monkeypatch):
    """build_server with its GroupedScheduler (``scheduler_groups`` > 1
    or ``device_worker``) replaced by a recorder."""
    from asr_streaming_tpu_torch.streaming import scheduler as sched_mod
    seen = []

    class Recorder(sched_mod.GroupedScheduler):
        """Records its keywords, then builds in process on the CPU."""
        def __init__(self, params, cfg, vocab, **kw):
            seen.append(dict(kw))
            if kw.pop("device_worker", None) is not None:
                kw["device"] = "cpu"
                params = ts.init_serving_params(0, cfg, "cpu")
            super().__init__(params, cfg, vocab, **kw)

    monkeypatch.setattr(sched_mod, "GroupedScheduler", Recorder)
    return seen


def test_data_parallel_flows_from_yaml_to_the_scheduler(tmp_path,
                                                        monkeypatch):
    """``data_parallel`` in the YAML reaches the scheduler as a mesh of
    that many shards without the device worker."""
    from asr_streaming_tpu_torch.server.__main__ import build_server
    from asr_streaming_tpu_torch.server.config import ServerSettings
    p = tmp_path / "s.yaml"
    p.write_text("language: vi\ndata_parallel: 2\nuse_silero: false\n"
                 "device_worker: false\nscheduler_groups: 2\n")
    settings = ServerSettings.load(str(p), env={})
    assert settings.data_parallel == 2
    assert ServerSettings.load(None, env={}).data_parallel == 1
    seen = _capture_schedulers(monkeypatch)
    build_server(settings, max_slots=4, device="cpu")
    (kw,) = seen
    assert kw["mesh"].shape == {"data": 2, "model": 1}
    assert "device" not in kw and "device_worker" not in kw


def test_data_parallel_is_dropped_with_a_warning_under_device_worker(
        tmp_path, monkeypatch, caplog):
    from asr_streaming_tpu_torch.server.__main__ import build_server
    from asr_streaming_tpu_torch.server.config import ServerSettings
    p = tmp_path / "s.yaml"
    p.write_text("language: vi\ndata_parallel: 0\nuse_silero: false\n"
                 "device_worker: true\n")
    seen = _capture_schedulers(monkeypatch)
    with caplog.at_level(logging.WARNING):
        build_server(ServerSettings.load(str(p), env={}), max_slots=4,
                     device="cpu")
    (kw,) = seen
    assert "mesh" not in kw and kw["device_worker"]["device"] == "cpu"
    assert any("data_parallel ignored" in r.getMessage()
               for r in caplog.records)
