"""Build TTS training manifests from (wav, transcript) pairs.

Counterpart of asr_streaming_tpu/tools/make_tts_manifest.py, on this
package's ``ASRModel`` (the card by default: ``--device cpu`` for the
plain versions; kernel A aligns there, in f32 at batch 1).  Bridges
the ASR and TTS halves of the framework: the TTS GAN trainer
(train/gan.py) needs per-word frame durations that the reference's
training corpus carried precomputed; this tool derives them with the
framework's own CTC forced alignment (decode/alignment.py; reference
LightningASR.force_alignment, recognition.py:162-189) so any
{"audio_filepath", "text"} ASR-style manifest becomes a TTS manifest:

  {"audio_filepath", "tokens": [ids...], "word_idxs": [word per token],
   "word_durations": [frames at the TTS hop]}

Durations tile the audio: word i spans from its aligned start to word
i+1's start (trailing/leading silences attach to the neighboring word),
converted to TTS frames (hop_length samples each) and rounded so the
per-utterance total matches the audio length — the length-regulator
contract of models/tts.py.

Run: ``python -m asr_streaming_tpu_torch.tools.make_tts_manifest \
        --manifest asr.jsonl --out tts.jsonl [--checkpoint am.npz]
        [--device cuda|cpu]``
"""

from __future__ import annotations

import argparse
import json
import logging
from typing import List, Sequence


def word_durations_from_alignment(word_segments: Sequence,
                                  audio_seconds: float, sample_rate: int,
                                  hop_length: int) -> List[int]:
    """Tile [0, audio_seconds] over the aligned words, in TTS frames.

    Boundary between consecutive words = midpoint of the inter-word gap;
    the first word absorbs the leading silence and the last the trailing
    silence.  Rounding error accumulates in the final word so the total
    equals the audio's frame count exactly.
    """
    total_frames = int(audio_seconds * sample_rate) // hop_length
    n = len(word_segments)
    if n == 0:
        return []
    if total_frames < n:
        # cannot give every word >= 1 frame: the sum==total contract is
        # unsatisfiable (degenerate audio/alignment) — caller skips
        return []
    bounds = [0.0]
    for i in range(n - 1):
        bounds.append(0.5 * (word_segments[i].end
                             + word_segments[i + 1].start))
    bounds.append(audio_seconds)
    frames_per_sec = sample_rate / hop_length
    durs, used = [], 0
    for i in range(n):
        if i == n - 1:
            d = total_frames - used
        else:
            d = int(round(bounds[i + 1] * frames_per_sec)) - used
        d = max(d, 1)
        durs.append(d)
        used += d
    # clamp possible overshoot from the max(d, 1) floor
    while used > total_frames and max(durs) > 1:
        j = max(range(n), key=lambda k: durs[k])
        durs[j] -= 1
        used -= 1
    return durs


def tokens_and_words(transcript: str, vocab, lexicon):
    """Token ids + per-token word index, mirroring the model's tokenizer
    (text/tokenizer.py).  Word boundaries follow whitespace words of the
    transcript; silence tokens ('|') between words belong to no word and
    are dropped (the TTS input is the spoken-token sequence)."""
    from asr_streaming_tpu_torch.text.tokenizer import tokenize

    index = {t: i for i, t in enumerate(vocab)}
    token_ids: List[int] = []
    word_idxs: List[int] = []
    words = transcript.split()
    for w, word in enumerate(words):
        for tok in tokenize(word, vocab, lexicon):
            if tok == "|" or tok not in index:
                continue
            token_ids.append(index[tok])
            word_idxs.append(w)
    return token_ids, word_idxs


def main(argv=None):
    """The manifest CLI; returns the number of entries written.  Its last
    log line holds the process's kernel launches (kernel A aligns on the
    card)."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--manifest", required=True,
                        help="JSONL with audio_filepath + text")
    parser.add_argument("--out", required=True)
    parser.add_argument("--checkpoint", default=None,
                        help="AM .npz for the aligner (random weights "
                        "give garbage alignments — fine only for "
                        "pipeline tests)")
    parser.add_argument("--hop-length", type=int, default=160)
    parser.add_argument("--min-words", type=int, default=1)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; cpu for tests)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("tts-manifest")

    from asr_streaming_tpu_torch.models.api import ASRModel
    from asr_streaming_tpu_torch.ops._cuda import launch_counts
    from asr_streaming_tpu_torch.train.data import load_manifest, read_wav

    model = ASRModel(checkpoint=args.checkpoint, device=args.device)
    sr = model.cfg.audio.sample_rate

    entries = load_manifest(args.manifest)
    n_ok = 0
    with open(args.out, "w") as f:
        for e in entries:
            wave, _ = read_wav(e["audio_filepath"])
            text = e["text"]
            try:
                _tok_segs, word_segs = model.force_alignment(wave, text)
            except Exception:
                log.exception("alignment failed for %s",
                              e["audio_filepath"])
                continue
            if len(word_segs) < args.min_words:
                log.warning("no aligned words for %s", e["audio_filepath"])
                continue
            token_ids, word_idxs = tokens_and_words(
                text, model.vocab, model.lexicon)
            n_words = max(word_idxs) + 1 if word_idxs else 0
            if n_words != len(word_segs):
                # tokenizer words and aligned words must correspond 1:1
                log.warning("word count mismatch (%d tokens-words vs %d "
                            "aligned) for %s — skipped", n_words,
                            len(word_segs), e["audio_filepath"])
                continue
            durs = word_durations_from_alignment(
                word_segs, len(wave) / sr, sr, args.hop_length)
            if not durs:
                log.warning("audio too short to tile %d words for %s — "
                            "skipped", len(word_segs),
                            e["audio_filepath"])
                continue
            f.write(json.dumps({
                "audio_filepath": e["audio_filepath"],
                "text": text,
                "tokens": token_ids,
                "word_idxs": word_idxs,
                "word_durations": durs,
            }) + "\n")
            n_ok += 1
    log.info("wrote %d/%d entries to %s", n_ok, len(entries), args.out)
    log.info("kernel launches: %s", json.dumps(launch_counts()))
    return n_ok


if __name__ == "__main__":
    main()
