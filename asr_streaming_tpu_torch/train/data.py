"""Datasets and collators for training (numpy; no tensor framework).

Copy of asr_streaming_tpu/train/data.py: JSONL manifests
({"audio_filepath", "text", "duration"} per line), the speech
recognition, classification, representation and synthesis datasets, and
collators that pad to caller-fixed (duration-bucketed) shapes.  Batches
carry padded waveforms; the frontend runs inside the train step.
"""

from __future__ import annotations

import dataclasses
import json
import wave as wave_mod
from typing import (
    Callable, Dict, Iterator, List, NamedTuple, Optional, Sequence,
)

import numpy as np

from asr_streaming_tpu_torch.text.tokenizer import tokenize


def load_manifest(path: str) -> List[dict]:
    """JSONL manifest (reference utils/common.py:21-30)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """16-bit PCM WAV -> (float32 mono [-1,1], sample_rate)."""
    with wave_mod.open(path) as f:
        sr = f.getframerate()
        n_ch = f.getnchannels()
        pcm = np.frombuffer(f.readframes(f.getnframes()), dtype=np.int16)
    if n_ch > 1:
        pcm = pcm.reshape(-1, n_ch)[:, 0]
    return pcm.astype(np.float32) / 32768.0, sr


@dataclasses.dataclass
class ASRExample:
    wave: np.ndarray
    tokens: np.ndarray     # int32 token ids
    text: str


class SpeechRecognitionDataset:
    """Manifest-backed ASR dataset (reference dataset.py:20-~100)."""

    def __init__(self, manifest_path: str, vocab: Sequence[str],
                 lexicon: Dict[str, List[str]],
                 augmentations: Sequence[Callable] = (),
                 min_duration: float = 0.1, max_duration: float = 40.0):
        self.entries = [
            e for e in load_manifest(manifest_path)
            if min_duration <= e.get("duration", 1.0) <= max_duration]
        self.vocab = list(vocab)
        self.index = {t: i for i, t in enumerate(self.vocab)}
        self.lexicon = lexicon
        self.augmentations = list(augmentations)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> ASRExample:
        entry = self.entries[i]
        wave, _sr = read_wav(entry["audio_filepath"])
        for aug in self.augmentations:
            wave = aug(wave)
        toks = tokenize(entry["text"], self.vocab, self.lexicon)
        ids = np.asarray([self.index[t] for t in toks if t in self.index],
                         np.int32)
        return ASRExample(wave=wave, tokens=ids, text=entry["text"])


@dataclasses.dataclass
class ASRBatch:
    waves: np.ndarray       # [B, T_bucket] float32
    wave_lens: np.ndarray   # [B] int32
    tokens: np.ndarray      # [B, L_bucket] int32
    token_lens: np.ndarray  # [B] int32


def collate_asr(examples: Sequence[ASRExample], wave_bucket: int,
                token_bucket: int) -> ASRBatch:
    """Pad to fixed bucket sizes."""
    B = len(examples)
    waves = np.zeros((B, wave_bucket), np.float32)
    tokens = np.zeros((B, token_bucket), np.int32)
    wave_lens = np.zeros(B, np.int32)
    token_lens = np.zeros(B, np.int32)
    for i, ex in enumerate(examples):
        n = min(len(ex.wave), wave_bucket)
        waves[i, :n] = ex.wave[:n]
        wave_lens[i] = n
        m = min(len(ex.tokens), token_bucket)
        tokens[i, :m] = ex.tokens[:m]
        token_lens[i] = m
    return ASRBatch(waves, wave_lens, tokens, token_lens)


def bucket_batches(dataset: SpeechRecognitionDataset, batch_size: int,
                   buckets_seconds: Sequence[float] = (4, 8, 16, 32),
                   sample_rate: int = 16000,
                   token_bucket: int = 256,
                   shuffle_seed: Optional[int] = 0,
                   ) -> Iterator[ASRBatch]:
    """Group examples into duration buckets; yield fixed-shape batches.
    Each distinct bucket is one batch shape."""
    order = np.arange(len(dataset))
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    pending: Dict[float, List[ASRExample]] = {b: [] for b in buckets_seconds}
    for i in order:
        ex = dataset[int(i)]
        secs = len(ex.wave) / sample_rate
        for b in buckets_seconds:
            if secs <= b:
                pending[b].append(ex)
                if len(pending[b]) == batch_size:
                    yield collate_asr(pending[b], int(b * sample_rate),
                                      token_bucket)
                    pending[b] = []
                break
    for b, exs in pending.items():
        if exs:   # pad the remainder up to batch_size with repeats
            while len(exs) < batch_size:
                exs.append(exs[-1])
            yield collate_asr(exs, int(b * sample_rate), token_bucket)


class SpeechClassificationDataset:
    """(wave, class-label) pairs, e.g. speaker ID (reference
    dataset.py SpeechClassificationDataset)."""

    def __init__(self, manifest_path: str, label_key: str = "label",
                 augmentations: Sequence[Callable] = ()):
        self.entries = load_manifest(manifest_path)
        labels = sorted({e[label_key] for e in self.entries})
        self.label_index = {l: i for i, l in enumerate(labels)}
        self.label_key = label_key
        self.augmentations = list(augmentations)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int):
        entry = self.entries[i]
        wave, _sr = read_wav(entry["audio_filepath"])
        for aug in self.augmentations:
            wave = aug(wave)
        return wave, self.label_index[entry[self.label_key]]


class SpeechRepresentationDataset:
    """Unlabeled audio for SSL (BEST-RQ) pretraining (reference
    SpeechRepresentationDataset)."""

    def __init__(self, manifest_path: str,
                 augmentations: Sequence[Callable] = ()):
        self.entries = load_manifest(manifest_path)
        self.augmentations = list(augmentations)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> np.ndarray:
        wave, _sr = read_wav(self.entries[i]["audio_filepath"])
        for aug in self.augmentations:
            wave = aug(wave)
        return wave


# ------------------------------------------------------------------- TTS

@dataclasses.dataclass
class TTSExample:
    tokens: np.ndarray      # [Tp] int32 phoneme/subword ids
    word_idxs: np.ndarray   # [Tp] int32 word index per token
    word_durs: np.ndarray   # [Tw] int32 frames per word (from alignment)
    audio: np.ndarray       # [T] float32


class TTSBatch(NamedTuple):
    tokens: np.ndarray       # [B, Tp_bucket] int32
    token_lens: np.ndarray   # [B] int32
    word_idxs: np.ndarray    # [B, Tp_bucket] int32
    word_durs: np.ndarray    # [B, Tw_bucket] int32
    audio: np.ndarray        # [B, T_bucket] float32
    audio_lens: np.ndarray   # [B] int32


class SpeechSynthesisDataset:
    """(tokens, word map, durations, audio) for TTS training (reference
    SpeechSynthesisDataset, v1 datas/dataset.py).  Manifest lines carry
    precomputed token/word ids and per-word frame durations (from a
    forced alignment — decode/alignment.py produces these):
    {"audio_filepath", "tokens": [int...], "word_idxs": [int...],
     "word_durations": [int...]}."""

    def __init__(self, manifest_path: str,
                 augmentations: Sequence[Callable] = ()):
        self.entries = load_manifest(manifest_path)
        self.augmentations = list(augmentations)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> TTSExample:
        e = self.entries[i]
        audio, _sr = read_wav(e["audio_filepath"])
        for aug in self.augmentations:
            audio = aug(audio)
        return TTSExample(
            tokens=np.asarray(e["tokens"], np.int32),
            word_idxs=np.asarray(e["word_idxs"], np.int32),
            word_durs=np.asarray(e["word_durations"], np.int32),
            audio=audio.astype(np.float32))


def collate_tts(examples: Sequence[TTSExample], token_bucket: int,
                hop_length: int, max_frames: int) -> TTSBatch:
    """Pad to fixed buckets; audio bucket = max_frames * hop (the
    generator's static output bound)."""
    B = len(examples)
    audio_bucket = max_frames * hop_length
    tokens = np.zeros((B, token_bucket), np.int32)
    # word_level_pooling treats only NEGATIVE ids as padding (see the
    # synthesize() contract) — 0-padding would pool every pad token into
    # word 0, contaminating its embedding and inflating its duration
    word_idxs = np.full((B, token_bucket), -1, np.int32)
    word_durs = np.zeros((B, token_bucket), np.int32)
    audio = np.zeros((B, audio_bucket), np.float32)
    token_lens = np.zeros(B, np.int32)
    audio_lens = np.zeros(B, np.int32)
    for i, ex in enumerate(examples):
        n = min(len(ex.tokens), token_bucket)
        tokens[i, :n] = ex.tokens[:n]
        word_idxs[i, :n] = ex.word_idxs[:n]
        token_lens[i] = n
        m = min(len(ex.word_durs), token_bucket)
        word_durs[i, :m] = ex.word_durs[:m]
        a = min(len(ex.audio), audio_bucket)
        audio[i, :a] = ex.audio[:a]
        audio_lens[i] = a
    return TTSBatch(tokens, token_lens, word_idxs, word_durs, audio,
                    audio_lens)


def tts_batches(dataset: SpeechSynthesisDataset, batch_size: int,
                hop_length: int, max_frames: int,
                token_bucket: int = 128,
                shuffle_seed: Optional[int] = 0) -> Iterator[TTSBatch]:
    order = np.arange(len(dataset))
    if shuffle_seed is not None:
        np.random.default_rng(shuffle_seed).shuffle(order)
    pending: List[TTSExample] = []
    for i in order:
        pending.append(dataset[int(i)])
        if len(pending) == batch_size:
            yield collate_tts(pending, token_bucket, hop_length, max_frames)
            pending = []
    if pending:
        while len(pending) < batch_size:
            pending.append(pending[-1])
        yield collate_tts(pending, token_bucket, hop_length, max_frames)
