"""Dual-language CLI client: stream one audio source to vi + en servers.

Equivalent of the reference's ``dual_asr_client.py`` / the bilingual
merger in ``test/asrclient.py:53-405``: fans the same PCM stream to both
language servers concurrently and merges their outputs — here with the
confidence-based conflict resolution the reference's merger sketches
(prefer the hypothesis with higher confidence per overlapping segment;
fall back to the vi result on ties, since the reference treats vi as
primary).

  python -m asr_streaming_tpu_torch.client.dual_client file.wav \
      --vi-url ws://localhost:6006/... --en-url ws://localhost:6016/...

Copied from asr_streaming_tpu/client/dual_client.py.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
from typing import List, Optional

from asr_streaming_tpu_torch.client.asr_client import (
    DEFAULT_PATH, TranscriptionResult, load_pcm, stream_audio,
)


@dataclasses.dataclass
class MergedSegment:
    start: float
    end: float
    text: str
    language: str
    confidence: float


def _segments(result: TranscriptionResult, language: str
              ) -> List[MergedSegment]:
    out = []
    for f in result.finals:
        hyp = f["result"]["hypotheses"][0]
        out.append(MergedSegment(
            start=f.get("segment_start", 0.0),
            end=f.get("segment_start", 0.0) + f.get("segment_length", 0.0),
            text=hyp.get("transcript", ""),
            language=language,
            confidence=hyp.get("confidence", 0.0)))
    return out


_VI_CHARS = ("àáạảãâầấậẩẫăằắặẳẵèéẹẻẽêềếệểễìíịỉĩòóọỏõôồốộổỗơờớợởỡ"
             "ùúụủũưừứựửữỳýỵỷỹđ")


def detect_language(text: str, default: str = "vi") -> str:
    """Diacritics-based language hint (the reference merger's
    _is_vietnamese_text check, test/asrclient.py:128-136)."""
    lowered = text.lower()
    if any(c in _VI_CHARS for c in lowered):
        return "vi"
    if lowered.strip() and all(ord(c) < 128 for c in lowered.strip()):
        return "en"
    return default


def make_vi_corrector(model: str = "bmd1905/vietnamese-correction-v2"):
    """HF text2text post-editor for Vietnamese finals (the reference
    merger loads the same model, test/asrclient.py:100).  Returns a
    callable or None if transformers/weights are unavailable (offline
    deployments keep working without it)."""
    try:
        from transformers import pipeline
        corrector = pipeline("text2text-generation", model=model)
    except Exception:
        return None

    def correct(text: str) -> str:
        if not text.strip():
            return text
        try:
            out = corrector(text, max_length=512)
            return out[0]["generated_text"]
        except Exception:
            return text

    return correct


def merge_bilingual(vi: List[MergedSegment], en: List[MergedSegment],
                    overlap_threshold: float = 0.5) -> List[MergedSegment]:
    """Confidence-based merge of overlapping vi/en segments; vi wins
    ties (the reference's merger treats vi as primary)."""
    merged: List[MergedSegment] = []
    used_en = set()
    for v in vi:
        winner = v
        for i, e in enumerate(en):
            inter = min(v.end, e.end) - max(v.start, e.start)
            shorter = max(1e-6, min(v.end - v.start, e.end - e.start))
            if inter / shorter >= overlap_threshold:
                used_en.add(i)
                if e.confidence > v.confidence:
                    winner = e
        merged.append(winner)
    for i, e in enumerate(en):
        if i not in used_en:
            merged.append(e)
    return sorted(merged, key=lambda s: s.start)


async def run_dual(pcm: bytes, vi_url: Optional[str], en_url: Optional[str],
                   realtime: bool = True):
    tasks = {}
    if vi_url:
        tasks["vi"] = stream_audio(vi_url, pcm, realtime=realtime)
    if en_url:
        tasks["en"] = stream_audio(en_url, pcm, realtime=realtime)
    results = dict(zip(tasks.keys(),
                       await asyncio.gather(*tasks.values())))
    vi_segs = _segments(results["vi"], "vi") if "vi" in results else []
    en_segs = _segments(results["en"], "en") if "en" in results else []
    return results, merge_bilingual(vi_segs, en_segs)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("wav")
    parser.add_argument("--vi-url",
                        default="ws://localhost:6006" + DEFAULT_PATH)
    parser.add_argument("--en-url", default=None)
    parser.add_argument("--no-realtime", action="store_true")
    parser.add_argument("--correct", action="store_true",
                        help="post-edit vi finals with the HF "
                             "vietnamese-correction model")
    args = parser.parse_args()

    pcm = load_pcm(args.wav)
    results, merged = asyncio.run(run_dual(
        pcm, args.vi_url, args.en_url, realtime=not args.no_realtime))
    corrector = make_vi_corrector() if args.correct else None
    for lang, res in results.items():
        print(f"[{lang}] {res.transcript}")
    print("--- merged ---")
    for seg in merged:
        text = seg.text
        if corrector and seg.language == "vi":
            text = corrector(text)
        print(f"[{seg.language} {seg.start:.2f}-{seg.end:.2f} "
              f"c={seg.confidence:.2f}] {text}")


if __name__ == "__main__":
    main()
