"""Plain reference of the Vietnamese CTC serving step, in float32.

One chunk for a batch of streams: mu-law decode and the carried audio
context, the energy gate and the per-window energy VAD, the routing
decision ``decode = active & (contain | (gate & speech))``, log-mel,
``input_linear`` and the stride-4 reduction, the streaming Emformer
(state reset and advanced by the flags) and the CTC head's log-probs.
A frozen copy of the port's ``models/serving.py::serving_step`` with
``models/encoder.py`` at float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference import audio, emformer


class CTCReference:
    def __init__(self, weights: dict, model: dict, device):
        self.w = weights
        self.m = model
        self.mel = audio.mel_params(model["mel"], device)
        self.device = device

    def zero_carry(self, batch: int) -> dict:
        a = self.m["audio"]
        return {"ctx": torch.zeros((batch, a["buffer_length"]),
                                   device=self.device),
                "state": emformer.zero_state(self.m["emformer"], batch,
                                             self.device)}

    def route(self, wave, active, contain):
        """(gate, speech, lead, trail, decode) of each slot."""
        a, thr = self.m["audio"], self.m["energy_threshold_db"]
        gate = audio.energy_gate(wave[:, a["buffer_length"]:],
                                 a["sample_rate"], thr)
        windows = audio.window_speech(wave, self.m["vad_window"], thr)
        lead, trail = audio.silence_runs(
            windows, self.m["vad_window"] / a["sample_rate"])
        speech = windows.any(1)
        return gate, speech, lead, trail, active & (contain | (gate & speech))

    def encode(self, seg_u8, contain, active, new_stream, reset, carry):
        """One chunk up to the Emformer: (route tuple, y [B, U, D], carry)."""
        wave, ctx = audio.assemble(seg_u8, carry["ctx"], active, new_stream)
        routed = self.route(wave, active, contain)
        feats = audio.log_mel(self.mel, self.m["mel"], wave)
        x = emformer.time_reduction(feats @ self.w["input_linear"]["w"], 4)
        y, state = emformer.step(self.w["emformer"], self.m["emformer"], x,
                                 carry["state"], reset, routed[-1])
        return routed, y, {"ctx": ctx, "state": state}

    def hidden(self, y):
        c = self.w["ctc"]
        return F.silu(y @ c["w1"] + c["b1"])

    def step(self, seg_u8, contain, active, new_stream, reset, carry):
        """One chunk.  Returns (route tuple, log-probs [B, U, V], carry)."""
        routed, y, carry = self.encode(seg_u8, contain, active, new_stream,
                                       reset, carry)
        c = self.w["ctc"]
        logits = self.hidden(y) @ c["w2"] + c["b2"]
        return routed, torch.log_softmax(logits, -1), carry
