"""WER/CER evaluation: score transcriptions against a reference manifest.

Counterpart of asr_streaming_tpu/tools/evaluate.py.  Batch-transcribes a
JSONL manifest ({"audio_filepath", "text"}) through the port's offline
ASRModel (greedy, or the lexicon+LM beam) on the card unless ``--device``
names another, and reports corpus WER/CER with per-utterance breakdowns:
Levenshtein alignment with substitutions, insertions and deletions
counted apart, the standard definition.

  python -m asr_streaming_tpu_torch.tools.evaluate --manifest eval.jsonl \
      [--checkpoint am.npz] [--beam --lexicon lex.txt --lm lm.arpa] \
      [--normalize] [--per-utt] [--hyp-manifest hyps.jsonl]

``EditStats``, ``edit_stats``, ``normalize_text``, ``word_error_rate``,
``char_error_rate`` and ``main`` are copied from that module, and
``load_manifest`` from asr_streaming_tpu/train/data.py.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import types
import unicodedata
from typing import List, Sequence


def load_manifest(path: str) -> List[dict]:
    """JSONL manifest (reference utils/common.py:21-30)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


@dataclasses.dataclass
class EditStats:
    substitutions: int = 0
    insertions: int = 0
    deletions: int = 0
    ref_len: int = 0

    @property
    def errors(self) -> int:
        return self.substitutions + self.insertions + self.deletions

    @property
    def rate(self) -> float:
        return self.errors / max(self.ref_len, 1)

    def __iadd__(self, other: "EditStats") -> "EditStats":
        self.substitutions += other.substitutions
        self.insertions += other.insertions
        self.deletions += other.deletions
        self.ref_len += other.ref_len
        return self


def edit_stats(ref: Sequence[str], hyp: Sequence[str]) -> EditStats:
    """Levenshtein alignment with S/I/D counts (uniform costs, the
    standard WER definition)."""
    R, H = len(ref), len(hyp)
    # dp[j] = (cost, subs, ins, dels) for prefix alignment
    prev = [(j, 0, j, 0) for j in range(H + 1)]
    for i in range(1, R + 1):
        cur = [(i, 0, 0, i)]
        for j in range(1, H + 1):
            if ref[i - 1] == hyp[j - 1]:
                cand = [(prev[j - 1][0], prev[j - 1], (0, 0, 0))]
            else:
                cand = [(prev[j - 1][0] + 1, prev[j - 1], (1, 0, 0))]
            cand.append((cur[j - 1][0] + 1, cur[j - 1], (0, 1, 0)))
            cand.append((prev[j][0] + 1, prev[j], (0, 0, 1)))
            cost, base, (ds, di, dd) = min(cand, key=lambda c: c[0])
            cur.append((cost, base[1] + ds, base[2] + di, base[3] + dd))
        prev = cur
    _cost, s, ins, dels = prev[H]
    return EditStats(substitutions=s, insertions=ins, deletions=dels,
                     ref_len=R)


def normalize_text(text: str) -> str:
    """Casefold + NFC + strip punctuation (keeps letters/digits/space)."""
    text = unicodedata.normalize("NFC", text).casefold()
    return " ".join("".join(
        c if (c.isalnum() or c.isspace()) else " " for c in text).split())


def word_error_rate(refs: Sequence[str], hyps: Sequence[str],
                    normalize: bool = False) -> EditStats:
    total = EditStats()
    for ref, hyp in zip(refs, hyps):
        if normalize:
            ref, hyp = normalize_text(ref), normalize_text(hyp)
        total += edit_stats(ref.split(), hyp.split())
    return total


def char_error_rate(refs: Sequence[str], hyps: Sequence[str],
                    normalize: bool = False) -> EditStats:
    total = EditStats()
    for ref, hyp in zip(refs, hyps):
        if normalize:
            ref, hyp = normalize_text(ref), normalize_text(hyp)
        total += edit_stats(list(ref.replace(" ", "")),
                            list(hyp.replace(" ", "")))
    return total


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", required=True,
                        help="JSONL: audio_filepath + text (reference)")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--beam", action="store_true",
                        help="lexicon+LM beam finals instead of greedy")
    parser.add_argument("--lexicon", default=None)
    parser.add_argument("--lm", default=None)
    parser.add_argument("--normalize", action="store_true",
                        help="casefold+strip punctuation before scoring")
    parser.add_argument("--per-utt", action="store_true")
    parser.add_argument("--hyp-manifest", default=None,
                        help="score precomputed hypotheses (JSONL with "
                        "'text') instead of running the model")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    entries = load_manifest(args.manifest)
    refs = [e["text"] for e in entries]

    decode_mode = "precomputed" if args.hyp_manifest else (
        "beam" if args.beam else "greedy")
    if args.hyp_manifest:
        hyps = [e["text"] for e in load_manifest(args.hyp_manifest)]
        if len(hyps) != len(refs):
            raise SystemExit(f"{len(hyps)} hypotheses for {len(refs)} "
                             "references")
    else:
        from asr_streaming_tpu_torch.models.api import ASRModel
        from asr_streaming_tpu_torch.utils.audio import read_wav
        model = ASRModel(checkpoint=args.checkpoint, device=args.device)
        decode = None
        if args.beam:
            # --beam never scores greedy output: it fails on missing
            # assets, and falls back to the (slow but exact) Python beam
            # when the native library cannot be built
            if not (args.lexicon and args.lm):
                raise SystemExit("--beam requires --lexicon and --lm")
            from asr_streaming_tpu_torch.decode.beam_native import (
                make_native_rescorer,
            )
            decode = make_native_rescorer(model.vocab, args.lexicon,
                                          args.lm)
            if decode is None:
                from asr_streaming_tpu_torch.decode.beam import make_rescorer
                decode = make_rescorer(model.vocab, args.lexicon, args.lm)
                decode_mode = "beam-python"
        hyps = []
        for e in entries:
            wave, _sr = read_wav(e["audio_filepath"])
            if decode is not None:
                emission = model.emissions(wave)
                alignment = decode(types.SimpleNamespace(
                    emission=emission, length=len(emission), offset=0))
                hyps.append(" ".join(a["word"] for a in alignment))
            else:
                hyps.append(model.transcribe(wave))

    wer = word_error_rate(refs, hyps, normalize=args.normalize)
    cer = char_error_rate(refs, hyps, normalize=args.normalize)
    if args.per_utt:
        for i, (r, h) in enumerate(zip(refs, hyps)):
            st = word_error_rate([r], [h], normalize=args.normalize)
            print(f"[{i}] wer={st.rate:.3f} ref={r!r} hyp={h!r}")
    print(json.dumps({
        "utterances": len(refs),
        "decode_mode": decode_mode,
        "wer": round(wer.rate, 4),
        "cer": round(cer.rate, 4),
        "substitutions": wer.substitutions,
        "insertions": wer.insertions,
        "deletions": wer.deletions,
        "ref_words": wer.ref_len,
    }))


if __name__ == "__main__":
    main()
