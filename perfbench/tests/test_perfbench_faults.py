"""A run with the timed path broken underneath comes out not correct.

Each test drives the whole of a run but the look for a card (the tiny
cells on the CPU, ``harness.run_cell``) with one fault planted in the
port's serving path, and judges it with the shipped cell's limits: a
step that returns its state unchanged, half of the batch left out, a
token altered where it is produced.  (The cells run on one chip, so no
exchange between chips can be left out.)  The sound run passes."""

import pytest
import torch

from perfbench import harness
from perfbench.tests.tiny import tiny_cell

SEED = 2**31 + 4242


def _patch_step(monkeypatch, wrap):
    """Wrap the step function each Scheduler builds."""
    from asr_streaming_tpu_torch.streaming import scheduler
    make = scheduler.make_serving_step
    monkeypatch.setattr(scheduler, "make_serving_step",
                        lambda cfg: wrap(make(cfg)))


def state_unchanged(step):
    def broken(params, cfg, seg, contain, active, new, reset, state, *rest):
        out = step(params, cfg, seg, contain, active, new, reset, state, *rest)
        return out._replace(state=state)
    return broken


def half_batch(step):
    def broken(params, cfg, seg, contain, active, new, reset, *rest):
        active = active.clone()
        active[1::2] = False
        return step(params, cfg, seg, contain, active, new, reset, *rest)
    return broken


def token_altered(step):
    def broken(params, cfg, *args):
        out = step(params, cfg, *args)
        pack = out.pack.clone()
        if cfg.model_kind == "ctc":
            V = cfg.asr.encoder.vocab_size
            pack[:, 5] = (pack[:, 5] + 1) % V
        else:
            # every token of the best hypothesis moved half the vocabulary
            V = cfg.rnnt.vocab_size
            pack[:, 6:] = (pack[:, 6:] + V // 2) % (V - 1)
        return out._replace(pack=pack)
    return broken


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "token_altered": token_altered}


def _run(name):
    torch.manual_seed(0)
    cell = tiny_cell(name)
    run, numbers, _, _ = harness.run_cell(cell, SEED, 2.5, False, "cpu")
    return harness.judge(numbers, cell.work["check"]["limits"]), numbers, run


@pytest.mark.parametrize("name", ["vi-ctc.sat512", "en-rnnt-beam.sat512"])
def test_sound_run_is_correct(name):
    """A sound run passes, and in its closed loop every chunk harvested in
    the window was offered and the drain harvests every chunk offered."""
    (correct, checks), numbers, run = _run(name)
    assert correct, checks
    assert numbers["chunks"] > 20
    assert run.failed == 0 and run.attempted >= run.chunks > 0
    if name.startswith("en"):
        assert numbers["beam_chunks"] > 10


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["vi-ctc.sat512", "en-rnnt-beam.sat512"])
def test_fault_is_caught(monkeypatch, name, fault):
    _patch_step(monkeypatch, FAULTS[fault])
    (correct, checks), _, _ = _run(name)
    assert not correct, checks
