"""Offline batch transcription CLI.

Counterpart of asr_streaming_tpu/tools/transcribe.py: transcribes one WAV
file without a running server.  It frames the file like the streaming
ring buffer, scans the model (models/api.py::ASRModel, on the card unless
``--device`` names another), and prints the greedy transcript and,
with a lexicon and an LM, the lexicon+LM beam's with word alignments.

  python -m asr_streaming_tpu_torch.tools.transcribe file.wav \\
      [--checkpoint ckpt.npz --vocab vocab.txt \\
       --lexicon lexicon.txt --lm lm.arpa] [--align "text"] \\
      [--segment [--vad-weights silero.npz|silero_vad.onnx]]
"""

from __future__ import annotations

import argparse
import json

import torch


def _vad_params(path, scfg, device):
    """Silero weights for ``--segment``: an ``.onnx`` (converted), a bare
    ``.npz`` tree, or random ones from seed 0."""
    from asr_streaming_tpu_torch.models.vad import (
        init_silero_params, silero_params_from_onnx,
    )
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params, params_from_numpy,
    )
    like = init_silero_params(torch.Generator().manual_seed(0), scfg, device)
    if path and path.endswith(".onnx"):
        from asr_streaming_tpu_torch.tools.onnx_weights import (
            load_onnx_initializers,
        )
        return params_from_numpy(silero_params_from_onnx(
            load_onnx_initializers(path), scfg), device)
    if path:
        return load_params(path, like=like)
    return like


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("wav")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--vocab", default=None)
    parser.add_argument("--lexicon", default=None)
    parser.add_argument("--lm", default=None)
    parser.add_argument("--align", default=None,
                        help="transcript to force-align instead of decode")
    parser.add_argument("--segment", action="store_true",
                        help="long-audio mode: VAD-segment into 3-15 s "
                        "speech groups and transcribe each with "
                        "timestamps (reference v1 detection.py flow)")
    parser.add_argument("--vad-weights", default=None,
                        help="silero npz/onnx for --segment (random "
                        "weights give poor segment boundaries)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)

    from asr_streaming_tpu_torch.models.api import ASRModel
    from asr_streaming_tpu_torch.text.corpus import corpus_paths
    from asr_streaming_tpu_torch.text.vocab import load_lexicon, load_vocab
    from asr_streaming_tpu_torch.utils.audio import read_wav
    from asr_streaming_tpu_torch.utils.resample import resample

    # default to the production corpus when no explicit paths are given
    if not args.lexicon:
        args.lexicon = corpus_paths().get("lexicon")
    vocab = load_vocab(args.vocab) if args.vocab else None
    lexicon = load_lexicon(args.lexicon) if args.lexicon else None
    model = ASRModel(checkpoint=args.checkpoint, vocab=vocab,
                     lexicon=lexicon, device=args.device)

    wave, sr = read_wav(args.wav)
    if sr != model.cfg.audio.sample_rate:
        wave = resample(wave, sr, model.cfg.audio.sample_rate)

    if args.align:
        tokens, words = model.force_alignment(wave, args.align)
        for w in words:
            print(f"{w.start:7.2f} {w.end:7.2f}  {w.label}"
                  f"  ({w.score:.2f})")
        return

    if args.segment:
        # long-audio pipeline: Silero timestamps -> 3-15 s groups ->
        # per-group decode (reference v1 models/detection.py:17-292)
        from asr_streaming_tpu_torch.models.segmenter import (
            get_speech_timestamps, group_segments,
        )
        from asr_streaming_tpu_torch.models.vad import SileroConfig

        scfg = SileroConfig()
        vad_params = _vad_params(args.vad_weights, scfg, model.device)
        sr16 = model.cfg.audio.sample_rate
        # timestamps come back in seconds (segmenter.py)
        segments = get_speech_timestamps(vad_params, scfg, wave)
        groups = group_segments(segments)
        for g in groups:
            lo = int(g["start"] * sr16)
            hi = int(g["end"] * sr16)
            text = model.transcribe(wave[lo:hi])
            print(f"{g['start']:7.2f} {g['end']:7.2f}  {text}")
        if not groups:
            print("(no speech segments found)")
        return

    print("greedy:", model.transcribe(wave))

    if args.lexicon and args.lm:
        emission = model.emissions(wave)
        try:
            from asr_streaming_tpu_torch.decode.beam_native import (
                NativeBeamDecoder,
            )
            decoder = NativeBeamDecoder(model.vocab, args.lexicon, args.lm)
            result = decoder.decode_full(emission)
            print("beam:  ", result["transcript"])
            print(json.dumps(result["alignment"], ensure_ascii=False,
                             indent=2))
        except RuntimeError:
            # no C++ compiler: the Python beam, as the JAX tool falls back
            from asr_streaming_tpu_torch.decode.beam import (
                ArpaLM, LexiconBeamDecoder,
            )
            decoder = LexiconBeamDecoder(
                model.vocab, load_lexicon(args.lexicon),
                ArpaLM.from_arpa(args.lm))
            result = decoder.decode(emission)
            print("beam:  ", result.transcript)


if __name__ == "__main__":
    main()
