"""On the card: each control (the port's own W8A8 path, the precision
below the configuration's bf16 encoder; for the transducer also TF32 on,
the precision below its float32 predictor and joiner) comes out not
correct, and the sound path correct, at a size a test run holds (64
streams, a 4 s window).
Skips without a CUDA device.  Run on the card with
``python3 -m pytest perfbench/tests/test_perfbench_gpu.py -m gpu``."""

import dataclasses

import pytest
import torch

from perfbench import harness


def _cell(name):
    cell = harness.load_cell(name)
    mix = dict(cell.mix, streams=64, warm_s=2.0)
    work = dict(cell.work, serving={"max_active_connections": 64,
                                    "scheduler_groups": 2})
    return dataclasses.replace(cell, mix=mix, work=work)


@pytest.mark.gpu
@pytest.mark.parametrize("name,control", [("vi-ctc.sat512", "int8"),
                                          ("en-rnnt-beam.sat512", "int8"),
                                          ("en-rnnt-beam.sat512", "tf32")])
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_control_fails_and_sound_passes(name, control, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = _cell(name)
    limits = cell.work["check"]["limits"]
    _, sound, _, _ = harness.run_cell(cell, seed, 4.0, False, "cuda")
    tf32 = control == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        _, ctl, _, _ = harness.run_cell(cell, seed, 4.0, False, "cuda",
                                        quant=None if tf32 else "int8")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    ok, checks = harness.judge(sound, limits)
    assert ok, checks
    ok, checks = harness.judge(ctl, limits)
    assert not ok, checks
