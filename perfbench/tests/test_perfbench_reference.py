"""The plain reference against the port's own step at the tiny widths on
the CPU (float32, the kernels' plain versions), so that the reference is
known right before it judges the card."""

import numpy as np
import pytest
import torch

from perfbench import harness, traffic
from perfbench.reference import audio
from perfbench.reference.ctc import CTCReference
from perfbench.reference.rnnt import NEG, VALID_FLOOR, Known, RNNTReference
from perfbench.tests.tiny import tiny_model

B, CHUNKS = 4, 8


def _inputs(model, seed):
    a = model["audio"]
    mix = dict(traffic.load_mix("sat512"), pool_s=20.0)
    tr = traffic.make_traffic(mix, seed, a["sample_rate"], a["segment_length"],
                              10.0)
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, len(tr.pool), B)
    for k in range(CHUNKS):
        seg = np.stack([audio.mulaw_encode(tr.chunk(int(o), k)) for o in offs])
        first = k == 0
        reset = np.full(B, first) | (rng.random(B) < 0.15)
        contain = rng.random(B) < 0.5
        active = rng.random(B) < 0.85
        yield (torch.from_numpy(seg), torch.from_numpy(contain),
               torch.from_numpy(active), torch.from_numpy(np.full(B, first)),
               torch.from_numpy(reset))


def _port(model, route):
    from asr_streaming_tpu_torch.models.serving import (
        init_audio_context, init_emission_buffer, init_serving_state,
        make_serving_step,
    )
    from asr_streaming_tpu_torch.streaming.scheduler import _apply_beam_cfg
    serving = dict(model["serving"], route=route)
    a = model["audio"]
    tr = traffic.make_traffic(dict(traffic.load_mix("sat512"), pool_s=20.0),
                              11, a["sample_rate"], a["segment_length"], 5.0)
    params, cfg, kw, _ = harness.serving_setup(model, serving, "cpu", 11, tr)
    if model["kind"] == "rnnt":
        cfg = _apply_beam_cfg(cfg, True, model["beam_width"], "device")
    state = init_serving_state(cfg, B, "cpu")
    ctx = init_audio_context(cfg, B, "cpu")
    buf = init_emission_buffer(cfg, B, "cpu")
    return params, cfg, make_serving_step(cfg), state, ctx, buf


def _route_equal(routed, pack):
    gate, speech, lead, trail, decode = routed
    assert torch.equal(decode.float(), pack[:, 0])
    assert torch.equal(gate.float(), pack[:, 1])
    assert torch.equal(speech.float(), pack[:, 2])
    assert torch.allclose(lead, pack[:, 3]) and torch.allclose(trail, pack[:, 4])


@pytest.mark.parametrize("route", ["stack", "off"])
def test_ctc_reference_matches_port(route):
    model = tiny_model("vi-ctc-emformer20")
    params, cfg, step, state, ctx, buf = _port(model, route)
    ref = CTCReference(params["encoder"], model, "cpu")
    carry = ref.zero_carry(B)
    U = model["emformer"]["segment_length"]
    length = np.zeros(B, int)
    decoded = 0
    with torch.no_grad():
        for seg, contain, active, new, reset in _inputs(model, 5):
            out = step(params, cfg, seg, contain, active, new, reset, state,
                       ctx, buf)
            state, ctx, buf = out.state, out.ctx, out.emission
            routed, lp, carry = ref.step(seg, contain, active, new, reset,
                                         carry)
            _route_equal(routed, out.pack)
            length[reset.numpy()] = 0
            for b in np.flatnonzero(routed[-1].numpy()):
                served = out.pack[b, 5:5 + U].long()
                gap = lp[b].max(-1).values - lp[b].gather(1, served[:, None])[:, 0]
                assert float(gap.max()) < 1e-4
                rows = buf[b, length[b]:length[b] + U].float()
                assert torch.allclose(rows, lp[b], atol=2e-2, rtol=2e-3)
                length[b] += U
                decoded += 1
            assert torch.allclose(ctx, carry["ctx"])
    assert decoded > 10


@pytest.mark.parametrize("route", ["stack", "off"])
def test_rnnt_reference_matches_port(route):
    """The transcriber's encodings, and the beam followed chunk by chunk
    from the port's own beam: the same best hypothesis and score, and the
    same sequence hashes.  (The beam runs on the reference's encodings:
    at float32 the port's beam reads its encodings before kernel B
    rounds them to float16, which on the card, at bf16, is exact.)"""
    model = tiny_model("en-rnnt-emformer-base")
    params, cfg, step, state, ctx, buf = _port(model, route)
    weights = {k: v for k, v in params.items() if k != "en_frontend"}
    ref = RNNTReference(weights, model, "cpu")
    carry = ref.zero_carry(B)
    known = [Known(ref) for _ in range(B)]
    U = model["emformer"]["segment_length"]
    length = np.zeros(B, int)
    emitted = followed = 0
    with torch.no_grad():
        for seg, contain, active, new, reset in _inputs(model, 6):
            before = state.beam
            out = step(params, cfg, seg, contain, active, new, reset, state,
                       ctx, buf)
            state, ctx, buf = out.state, out.ctx, out.emission
            routed, enc, carry = ref.step(seg, contain, active, new, reset,
                                          carry)
            _route_equal(routed, out.pack)
            length[reset.numpy()] = 0
            follow = np.flatnonzero(routed[-1].numpy())
            for b in follow:
                rows = buf[b, length[b]:length[b] + U].float()
                assert torch.allclose(rows, enc[b], atol=5e-3, rtol=2e-3)
                length[b] += U
            if not len(follow):
                continue
            toks = before.tokens.numpy()[follow]
            lens = before.lengths.numpy()[follow]
            scs = before.scores.numpy()[follow].copy()
            for i, b in enumerate(follow):
                if reset[b]:
                    known[b].keep({})
                    toks[i], lens[i], scs[i] = 0, 0, NEG
                    scs[i, 0] = 0.0
            beam = ref.follow(enc[follow], [known[b] for b in follow],
                              toks, lens, scs)
            after = state.beam
            for i, b in enumerate(follow):
                n = int(after.lengths[b, 0])
                assert int(beam.lengths[i, 0]) == n
                assert torch.equal(beam.tokens[i, 0, :n], after.tokens[b, 0, :n])
                assert abs(float(beam.scores[i, 0] - after.scores[b, 0])) < 1e-4
                live = after.scores[b] > VALID_FLOOR
                assert torch.equal(beam.h1[i][live], after.h1[b][live])
                assert torch.equal(beam.h2[i][live], after.h2[b][live])
                got = out.pack[b, 6:6 + int(out.pack[b, 5])].long()
                assert torch.equal(got, after.tokens[b, 0, :n].long())
                emitted += n
                followed += 1
    assert emitted > 0 and followed > 10


def test_known_states_are_the_predictor_over_the_tokens():
    """A hypothesis's state worked out from a kept prefix is the predictor
    run over its whole token sequence, and its hash the port's."""
    from asr_streaming_tpu_torch.models.rnnt_beam import (
        _HASH_INIT1, _HASH_INIT2, _HASH_M1, _HASH_M2,
    )
    model = tiny_model("en-rnnt-emformer-base")
    params, *_ = _port(model, "off")
    weights = {k: v for k, v in params.items() if k != "en_frontend"}
    ref = RNNTReference(weights, model, "cpu")
    toks = (3, 17, 0, 29, 5)
    with torch.no_grad():
        known = Known(ref)
        known.keep({toks[:2]: known.get(toks[:2])})
        before = known.computed
        hyp = known.get(toks)
        assert known.computed - before == 3      # from the kept prefix
        h, c = ref._zero_pred(1)
        out, h, c = ref.predictor(torch.tensor([ref.blank]), h, c)
        for t in toks:
            out, h, c = ref.predictor(torch.tensor([t]), h, c)
    assert torch.allclose(hyp[4], out[0], atol=1e-6)
    assert torch.allclose(hyp[2], h[:, 0], atol=1e-6)
    h1 = torch.tensor([_HASH_INIT1], dtype=torch.int32)
    h2 = torch.tensor([_HASH_INIT2], dtype=torch.int32)
    for t in toks:
        h1 = h1 * _HASH_M1 + (t + 1)
        h2 = h2 * _HASH_M2 + (t + 1)
    assert (hyp[0], hyp[1]) == (int(h1), int(h2))
