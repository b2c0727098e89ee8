"""High-level model API: the offline and library surface.

Counterpart of asr_streaming_tpu/models/api.py (``ASRModel``), the shape
of the reference's ``LightningASR`` (reference:
lightspeech/models/recognition.py:136-217): checkpoint load, batched
``stream``, ``init_state``, full-utterance ``emissions``, greedy
``transcribe`` and ``force_alignment``.  The serving path uses the
functional API directly (models/serving.py).

It runs on the card unless the caller names another device.  The default
model is ``ASRConfig.vietnamese()`` (f32, kernel A's stack route), so on
the card ``emissions`` runs kernel A once per chunk at batch 1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.decode.alignment import force_align
from asr_streaming_tpu_torch.decode.greedy import greedy_search_full
from asr_streaming_tpu_torch.models.asr import (
    ASRConfig, asr_offline_logprobs, asr_stream_step, frame_waveform,
    init_asr_params, init_asr_state,
)
from asr_streaming_tpu_torch.models.emformer import EmformerState
from asr_streaming_tpu_torch.text.corpus import load_corpus
from asr_streaming_tpu_torch.text.tokenizer import tokenize
from asr_streaming_tpu_torch.text.vocab import placeholder_vocab
from asr_streaming_tpu_torch.utils.checkpoint import load_params


class ASRModel:
    """Checkpoint-backed Vietnamese streaming/offline ASR."""

    def __init__(self, cfg: Optional[ASRConfig] = None,
                 checkpoint: Optional[str] = None,
                 vocab: Optional[Sequence[str]] = None,
                 lexicon: Optional[Dict[str, List[str]]] = None,
                 seed: int = 0, use_corpus: bool = True, device=None):
        """Random weights from ``seed`` (a torch.Generator), overlaid by
        ``checkpoint`` (an ``.npz`` of the same tree), on ``device``
        (default CUDA; raises without it)."""
        self.device = resolve_device(device)
        self.cfg = cfg or ASRConfig.vietnamese()
        if vocab is None and use_corpus:
            # the production corpus (804-token vocab, reference
            # lightspeech/datas/text.py:27-38) sizes the CTC head
            cvocab, clex = load_corpus()
            if cvocab is not None:
                vocab = cvocab
                lexicon = lexicon or clex
                if cfg is None:
                    self.cfg = dataclasses.replace(
                        self.cfg, encoder=dataclasses.replace(
                            self.cfg.encoder, vocab_size=len(cvocab)))
        self.params = init_asr_params(torch.Generator().manual_seed(seed),
                                      self.cfg, self.device)
        if checkpoint:
            self.params = load_params(checkpoint, like=self.params)
        self.vocab = list(vocab) if vocab else placeholder_vocab(
            self.cfg.encoder.vocab_size)
        self.lexicon = lexicon or {}

    # ------------------------------------------------------------ streaming

    def init_state(self, batch_size: int = 1) -> EmformerState:
        """(reference recognition.py:207-217)"""
        return init_asr_state(self.cfg, batch_size, self.device)

    def stream(self, chunks: np.ndarray, state: EmformerState
               ) -> Tuple[np.ndarray, EmformerState]:
        """One decode step over [B, chunk_length] audio windows ->
        (log_probs [B, U, V], new_state)  (reference recognition.py:191-204)
        """
        wave = torch.as_tensor(np.asarray(chunks, np.float32),
                               device=self.device)
        out = asr_stream_step(self.params, self.cfg, wave, state)
        return out.log_probs.cpu().numpy(), out.state

    # -------------------------------------------------------------- offline

    def _emission_tensor(self, waveform: np.ndarray) -> torch.Tensor:
        chunks = frame_waveform(np.asarray(waveform, np.float32),
                                self.cfg.audio)
        chunks = torch.from_numpy(chunks)[:, None].to(self.device)
        return asr_offline_logprobs(self.params, self.cfg, chunks)[0]

    def emissions(self, waveform: np.ndarray) -> np.ndarray:
        """Full-utterance CTC log-probs [T, V] via the chunk scan."""
        return self._emission_tensor(waveform).cpu().numpy()

    def transcribe(self, waveform: np.ndarray) -> str:
        """Offline greedy transcription."""
        text, _ = greedy_search_full(self.emissions(waveform), self.vocab)
        return text

    def force_alignment(self, waveform: np.ndarray, transcript: str):
        """Token/word segments for a known transcript (reference
        recognition.py:162-189); the trellis runs on the model's device."""
        emission = self._emission_tensor(waveform)
        tokens = tokenize(transcript, self.vocab, self.lexicon)
        index = {t: i for i, t in enumerate(self.vocab)}
        token_ids = [index[t] for t in tokens if t in index]
        audio_seconds = len(waveform) / self.cfg.audio.sample_rate
        return force_align(emission, token_ids,
                           [self.vocab[i] for i in token_ids],
                           audio_seconds)
