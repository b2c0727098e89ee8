"""Wire protocol: result schema + v1 command protocol.

Mirrors the reference's ``DecodedResult`` dataclass (reference:
streaming_decoder/utils.py:26-42), the hypotheses payload builders
(utils.py:142-188), and the v1 JSON command protocol
(``__SET_AUDIO_FORMAT__`` / ``__EOS__`` / ``__REQUEST_COMPLETED__``,
reference: streaming_decoder_v1/streaming_server.py:299-332, 567-593).
The current-generation reference server ignores text frames entirely
(its own web client's 'Done' goes unanswered — a protocol gap noted in
SURVEY.md §3.5); here both generations are unified: JSON commands, plus
bare 'Done'/'EOS' strings, all trigger the EOS flush.

Copied from asr_streaming_tpu/server/protocol.py.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Union


@dataclasses.dataclass
class DecodedResult:
    id: str = ""
    status: int = 0
    # the reference annotates msg as int but never assigns it
    # (utils.py:30; its result field even declares default_factory=str
    # for a Dict) — this rebuild uses msg to carry the human-readable
    # error string on status != 0 notices (e.g. unknown __SET_LM_MODEL__
    # name) and 0 otherwise
    msg: Union[int, str] = 0
    segment: int = 0
    result: Dict = dataclasses.field(default_factory=dict)
    segment_start: float = 0.0
    segment_length: float = 0.0
    total_length: float = 0.0
    message_type: int = 0
    word_start: float = 0.0
    word_end: float = 0.0
    snr: float = 0.0
    vol_noise: float = 0.0
    vol_speech: float = 0.0
    is_speaker: bool = False

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), ensure_ascii=False)


def create_hypotheses(transcript: str) -> dict:
    """Partial-result payload (reference utils.py:142-151)."""
    return {
        "transcript": transcript,
        "transcript_normalized": transcript,
        "confidence": 0.0,
        "likelihood": 1.0,
        "word_alignment": [],
    }


def hypotheses_from_alignment(alignment: List[dict],
                              normalized: Optional[str] = None) -> dict:
    """Final-result payload from a word-alignment list of
    {beg, end, word, confidence} items (reference utils.py:154-181)."""
    word_alignments, confidences, words = [], [], []
    for part in alignment:
        word = part["word"].replace("<<", "").replace(">>", "")
        word_alignments.append({
            "word": word,
            "start": part["beg"],
            "length": round(part["end"] - part["beg"], 2),
            "confidence": part["confidence"],
        })
        confidences.append(part["confidence"])
        words.append(word)
    transcript = " ".join(words)
    return {
        "transcript": transcript,
        "transcript_normalized": (normalized if normalized is not None
                                  else transcript),
        "confidence": round(sum(confidences) / len(confidences), 2)
        if confidences else 0,
        "word_alignment": word_alignments,
    }


def hypotheses_en(transcript: str) -> dict:
    return {"transcript": transcript, "transcript_normalized": transcript}


# ---------------------------------------------------------------- commands

CMD_SET_AUDIO_FORMAT = "__SET_AUDIO_FORMAT__"
CMD_SET_LM_MODEL = "__SET_LM_MODEL__"
CMD_EOS = "__EOS__"
MSG_REQUEST_COMPLETED = "__REQUEST_COMPLETED__"
EOS_STRINGS = {"Done", "EOS", "__EOS__"}


@dataclasses.dataclass
class Command:
    kind: str          # "set_format" | "set_lm_model" | "eos" | "unknown"
    request_id: str = ""
    sample_rate: Optional[int] = None
    lm_model: Optional[str] = None   # Linguistic_Model registry key; sets
                                     # stream.sw_model (reference
                                     # stream.py:32 defaults GENERAL; the
                                     # reference ships no setter — this is
                                     # the v1-protocol carrier for it)


def parse_text_message(text: str) -> Command:
    """Parse a text frame into a protocol command."""
    stripped = text.strip()
    if stripped in EOS_STRINGS:
        return Command(kind="eos")
    try:
        blob = json.loads(stripped)
    except (json.JSONDecodeError, ValueError):
        return Command(kind="unknown")
    cmd = blob.get("__COMMAND__", "")
    if cmd == CMD_EOS:
        return Command(kind="eos", request_id=str(blob.get("request-id", "")))
    if cmd == CMD_SET_AUDIO_FORMAT:
        arg = blob.get("__ARGUMENT__", {}) or {}
        return Command(kind="set_format",
                       request_id=str(blob.get("request-id", "")),
                       sample_rate=arg.get("sample_rate"))
    if cmd == CMD_SET_LM_MODEL:
        arg = blob.get("__ARGUMENT__", {}) or {}
        model = arg.get("model") if isinstance(arg, dict) else arg
        return Command(kind="set_lm_model",
                       request_id=str(blob.get("request-id", "")),
                       lm_model=str(model) if model else None)
    return Command(kind="unknown")
