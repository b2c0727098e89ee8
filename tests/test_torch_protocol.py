"""The port's wire protocol against the JAX package's: the same strings
on the same inputs (text commands, DecodedResult JSON, final and English
hypotheses), drawn from a seed."""

import dataclasses
import json

import numpy as np
import pytest

from asr_streaming_tpu.server import protocol as jp
from asr_streaming_tpu_torch.server import protocol as tp

MESSAGES = [
    "Done", "EOS", " __EOS__ ", "garbage{", "", "{}",
    json.dumps({"__COMMAND__": "__EOS__", "request-id": "r9"}),
    json.dumps({"__COMMAND__": "__SET_AUDIO_FORMAT__",
                "__ARGUMENT__": {"sample_rate": 44100}, "request-id": "r1"}),
    json.dumps({"__COMMAND__": "__SET_AUDIO_FORMAT__", "__ARGUMENT__": None}),
    json.dumps({"__COMMAND__": "__SET_LM_MODEL__",
                "__ARGUMENT__": {"model": "LEGAL"}}),
    json.dumps({"__COMMAND__": "__SET_LM_MODEL__", "__ARGUMENT__": "MEDICAL",
                "request-id": 7}),
    json.dumps({"__COMMAND__": "__SET_LM_MODEL__", "__ARGUMENT__": {}}),
    json.dumps({"__COMMAND__": "__NOPE__"}),
]


@pytest.mark.parametrize("text", MESSAGES)
def test_parse_text_message_matches(text):
    assert dataclasses.asdict(tp.parse_text_message(text)) == \
        dataclasses.asdict(jp.parse_text_message(text))


def test_non_object_json_raises_in_both():
    """A JSON text frame that is not an object raises in both parsers (the
    handler then ends that connection); the port keeps the reference's
    behaviour."""
    for mod in (tp, jp):
        with pytest.raises(AttributeError):
            mod.parse_text_message("[1, 2]")


def _alignment(rng, n):
    words = ["xin", "chào", "<<việt>>", "nam", "ab", "cd"]
    t = 0.0
    out = []
    for _ in range(n):
        beg = round(t + float(rng.uniform(0, 0.3)), 2)
        end = round(beg + float(rng.uniform(0.04, 0.8)), 2)
        out.append({"beg": beg, "end": end,
                    "word": words[int(rng.integers(len(words)))],
                    "confidence": round(float(rng.uniform(0, 1)), 3)})
        t = end
    return out


@pytest.mark.parametrize("seed", range(4))
def test_result_json_matches(seed):
    rng = np.random.default_rng(seed)
    align = _alignment(rng, seed * 2)
    normalized = None if seed % 2 else "bình thường hóa"
    hyps = [(tp.hypotheses_from_alignment(align, normalized),
             jp.hypotheses_from_alignment(align, normalized)),
            (tp.hypotheses_en(" a b"), jp.hypotheses_en(" a b")),
            (tp.create_hypotheses("xin chào"),
             jp.create_hypotheses("xin chào"))]
    for th, jh in hyps:
        assert json.dumps(th, ensure_ascii=False) == \
            json.dumps(jh, ensure_ascii=False)
        fields = dict(id=f"s{seed}", segment=seed,
                      segment_length=float(rng.uniform(0, 9)),
                      total_length=float(rng.uniform(9, 20)),
                      snr=float(rng.normal()), is_speaker=bool(seed % 2),
                      result={"hypotheses": [th], "final": bool(seed % 2)})
        t, j = tp.DecodedResult(**fields), jp.DecodedResult(**fields)
        assert t.to_json() == j.to_json()
    assert tp.MSG_REQUEST_COMPLETED == jp.MSG_REQUEST_COMPLETED == \
        "__REQUEST_COMPLETED__"
