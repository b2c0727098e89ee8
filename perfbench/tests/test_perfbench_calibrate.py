"""The blank calibration gives every seed the same emission behaviour:
the blank best on the configured share of voiced frames and leading on
silence (tiny widths, the plain reference, the CPU)."""

import pytest
import torch

from perfbench import traffic
from perfbench.calibrate import _frames, calibrate
from perfbench.reference.ctc import CTCReference
from perfbench.tests.tiny import tiny_model
from perfbench.weights import ctc_weights


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_ctc_blank_share_and_silence(seed):
    model = tiny_model("vi-ctc-emformer20")
    a = model["audio"]
    tr = traffic.make_traffic(dict(traffic.load_mix("sat512"), pool_s=30.0),
                              seed, a["sample_rate"], a["segment_length"], 5.0)
    w = ctc_weights(seed, model, "cpu")
    calibrate(w, model, tr, "cpu", streams=6, chunks=12)
    ref = CTCReference(w, model, "cpu")
    with torch.no_grad():
        y, labels = _frames(ref, model, tr, "cpu", 6, 12)
        logits = ref.hidden(y) @ w["ctc"]["w2"] + w["ctc"]["b2"]
    blank = logits.argmax(1) == model["blank"]
    share = blank[labels > 0].float().mean()
    assert abs(float(share) - model["weights"]["blank_share"]) < 0.05
    assert float(blank[labels < 0].float().mean()) > 0.95


@pytest.mark.parametrize("seed", [1, 2**31 + 9])
def test_rnnt_greedy_emission_share(seed):
    """The transducer's greedy decoding from the blank emits on about the
    configured share of voiced frames, whatever the seed (at the tiny
    widths the share jumps by some tenths as the blank's bias crosses the
    target, so it is held to 0.15), and little on silence."""
    from perfbench.calibrate import _greedy_emits
    from perfbench.reference.rnnt import RNNTReference
    from perfbench.weights import rnnt_weights
    model = tiny_model("en-rnnt-emformer-base")
    a = model["audio"]
    tr = traffic.make_traffic(dict(traffic.load_mix("sat512"), pool_s=30.0),
                              seed, a["sample_rate"], a["segment_length"], 5.0)
    w = rnnt_weights(seed, model, "cpu")
    calibrate(w, model, tr, "cpu", streams=4, chunks=40)
    ref = RNNTReference(w, model, "cpu")
    U = model["emformer"]["segment_length"]
    with torch.no_grad():
        enc, labels = _frames(ref, model, tr, "cpu", 4, 40)
        seq = enc.reshape(40, 4, U, -1).permute(1, 0, 2, 3).reshape(4, 40 * U, -1)
        lab = labels.reshape(40, 4, U).permute(1, 0, 2).reshape(4, -1)
        emits = _greedy_emits(ref, seq)
    share = float(emits[lab > 0].float().mean())
    assert abs(share - (1 - model["weights"]["blank_share"])) < 0.15
    assert float(emits[lab < 0].float().mean()) < 0.05
