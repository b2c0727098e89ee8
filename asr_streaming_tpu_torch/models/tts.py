"""Text-to-speech model (training-lineage TTS path).

Counterpart of asr_streaming_tpu/models/tts.py, the re-design of the
reference's ``LightningTTS`` (reference:
streaming_decoder_v1/lightspeech/models/synthesis.py:21-198): tokenized
text -> LinguisticEncoder (phoneme/word Squeezeformer + duration predictor
+ length regulator + word->phoneme attention) -> WaveformDecoder
(Squeezeformer stack -> mag/phase -> iSTFT vocoder).  Trained with the
multi-resolution STFT + LS-GAN losses (train/losses.py) against the
discriminator zoo (models/discriminators.py) by train/gan.py, whose
``.npz`` loads into ``TTSModel`` (and into the JAX package's).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from asr_streaming_tpu_torch import resolve_device
from asr_streaming_tpu_torch.models.offline import (
    LinguisticConfig, SqueezeformerConfig, init_linguistic_encoder_params,
    init_waveform_decoder_params, linguistic_encoder, waveform_decoder,
)
from asr_streaming_tpu_torch.utils.checkpoint import load_params


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    linguistic: LinguisticConfig = dataclasses.field(
        default_factory=LinguisticConfig)
    decoder: SqueezeformerConfig = dataclasses.field(
        default_factory=lambda: SqueezeformerConfig(
            d_model=256, num_layers=4, attn_num_heads=4,
            attn_max_pos_encoding=2048, conv_kernel_size=15))
    n_fft: int = 800
    win_length: int = 400
    hop_length: int = 160
    max_frames: int = 2048       # static bound for the length regulator

    @classmethod
    def tiny(cls) -> "TTSConfig":
        return cls(
            linguistic=LinguisticConfig(
                vocab_size=32, d_model=32, num_layers=1, attn_num_heads=4,
                attn_max_pos_encoding=128, conv_kernel_size=7),
            decoder=SqueezeformerConfig(
                d_model=32, num_layers=1, attn_num_heads=4,
                attn_max_pos_encoding=256, conv_kernel_size=7),
            n_fft=128, win_length=128, hop_length=32, max_frames=256)


def load_tar_checkpoint(filepath: str):
    """Load the reference's TTS tar checkpoint format (reference:
    streaming_decoder_v1/lightspeech/models/synthesis.py:21-37): a tarball
    holding ``config.yaml`` + ``encoder.pt`` + ``decoder.pt``.

    Returns (config_dict, encoder_state_dict, decoder_state_dict) with
    tensors as numpy arrays; callers map them onto init_tts_params-shaped
    trees (torch Linear weights need the usual [out,in]->[in,out]
    transpose).
    """
    import os
    import tarfile
    import tempfile

    import yaml

    with tempfile.TemporaryDirectory() as tmpdir:
        with tarfile.open(filepath, "r") as tar:
            tar.extractall(path=tmpdir, filter="data")
        with open(os.path.join(tmpdir, "config.yaml")) as f:
            config = yaml.safe_load(f)

        def load_sd(name):
            blob = torch.load(os.path.join(tmpdir, name),
                              map_location="cpu", weights_only=False)
            sd = blob.get("state_dict", blob) if isinstance(blob, dict) \
                else blob
            return {k: np.asarray(v.detach().cpu().numpy()
                                  if hasattr(v, "detach") else v)
                    for k, v in sd.items()}

        return config, load_sd("encoder.pt"), load_sd("decoder.pt")


def init_tts_params(gen: torch.Generator, cfg: TTSConfig,
                    device=None) -> dict:
    assert cfg.linguistic.d_model == cfg.decoder.d_model, \
        "linguistic/decoder dims must match"
    return {
        "linguistic": init_linguistic_encoder_params(gen, cfg.linguistic,
                                                     device),
        "decoder": init_waveform_decoder_params(gen, cfg.decoder, cfg.n_fft,
                                                device),
    }


def synthesize(params: dict, cfg: TTSConfig, token_idxs: torch.Tensor,
               token_lens: torch.Tensor, word_idxs: torch.Tensor,
               word_durs: Optional[torch.Tensor] = None,
               training: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Text -> waveform.

    Args:
      token_idxs: [B, Tp] phoneme/subword ids; word_idxs: [B, Tp] word
        indices per token (-1 padding); word_durs: optional ground-truth
        frame durations [B, Tw] (teacher forcing; else predicted).
    Returns:
      (audio [B, 1, T_samples], audio_lens [B], predicted_word_durs)
    """
    enc, enc_lens, durs_pred = linguistic_encoder(
        params["linguistic"], cfg.linguistic, token_idxs, token_lens,
        word_idxs, word_durs=word_durs, max_out=cfg.max_frames,
        training=training)
    audio, audio_lens = waveform_decoder(
        params["decoder"], cfg.decoder, enc,
        torch.clamp(enc_lens, 1, cfg.max_frames), cfg.n_fft, cfg.win_length,
        cfg.hop_length, training=training)
    return audio, audio_lens, durs_pred


class TTSModel:
    """Checkpoint-backed synthesis wrapper (reference LightningTTS): random
    weights from ``seed`` (a torch.Generator) overlaid by ``checkpoint``
    (an ``.npz`` of the same tree), on ``device`` (default CUDA; raises
    without it).  Calls run under ``torch.no_grad`` and return numpy."""

    def __init__(self, cfg: TTSConfig, checkpoint: Optional[str] = None,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = init_tts_params(torch.Generator().manual_seed(seed),
                                      cfg, self.device)
        if checkpoint:
            self.params = load_params(checkpoint, like=self.params)

    def __call__(self, token_idxs: np.ndarray, word_idxs: np.ndarray
                 ) -> np.ndarray:
        def t(a):
            return torch.as_tensor(np.asarray(a), device=self.device)[None]

        with torch.no_grad():
            audio, audio_lens, _ = synthesize(
                self.params, self.cfg, t(token_idxs),
                torch.tensor([len(token_idxs)], device=self.device),
                t(word_idxs))
        return audio[0, 0, :int(audio_lens[0])].cpu().numpy()
