"""Server configuration: YAML + env overrides.

Mirrors the reference's OmegaConf config surface (reference:
streaming_decoder/config/asr-online.yaml, env vars PORT/LANGUAGE at
streaming_server.py:15,53,143) without the Hydra dependency: a plain YAML
file with the same sections (language, audio geometry, endpointing rules,
LM paths, VAD/speaker thresholds) plus framework-specific keys (checkpoint
path, slots, dtype).

Copied from asr_streaming_tpu/server/config.py, with one repair: a flat
``endpoint_rules`` also replaces ``endpoint_rulesets["DEFAULT"]``, which
``Stream`` consults first (the JAX loader loses the override when the
file also has ``Endpointing_rules``).  ``quant`` and the rest are decided
here once; build_server puts them in the ServingConfig the device worker
receives pickled.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
from typing import Any, Dict, Optional

import yaml

from asr_streaming_tpu_torch.streaming.endpoint import (
    EN_DEFAULT_RULES, NgramEndpointCost, VI_DEFAULT_RULES,
    load_endpoint_rules,
)
from asr_streaming_tpu_torch.utils.audio import AudioConfig, EN_AUDIO, VI_AUDIO


# Top-level keys that identify the reference's own OmegaConf layout
# (streaming_decoder/config/asr-online{,-en}.yaml): when any is present the
# nested sections are mapped onto this framework's flat settings so an
# UNMODIFIED reference config file boots the server (asset paths resolve
# where the deploy tree exists; missing files warn and degrade, matching
# the null-key behavior).
_REFERENCE_MARKERS = ("Acoustic_Model", "Linguistic_Model", "Vad",
                      "Speaker_Diar", "LM_Endpointing", "EmformerRNNT")

logger = logging.getLogger(__name__)


def _existing_path(candidates, key: str) -> Optional[str]:
    """First existing path among candidates; warn (once, loudly) when the
    reference config maps an asset this host doesn't have."""
    candidates = [c for c in candidates if c]
    for c in candidates:
        if os.path.exists(c):
            return c
    if candidates:
        logger.warning(
            "reference config maps %s -> %s (not present on this host); "
            "leaving unset — the server boots degraded (see MIGRATION.md)",
            key, candidates[0])
    return None


def _apply_reference_layout(s: "ServerSettings", blob: Dict[str, Any],
                            config_path: Optional[str]) -> None:
    """Map the reference's nested config sections onto ServerSettings.

    Path-resolution semantics follow the reference exactly:
      * Acoustic_Model.filepath joins model_dir (recognition.py:147);
      * EN assets live under dirname(model_dir)/emformer-rnnt/
        (recognition.py:99-119: emformer_rnnt.pt, spm_bpe_4096.model,
        global_stats_rnnt.json);
      * Linguistic_Model lexicon/lm join corpus_dir (recognition.py:238-239);
      * Vad.Silero.model_path is cwd-relative in the reference — here also
        tried against the config dir and the deploy root
        (dirname(dirname(model_dir)));
      * Speaker_Diar.{model_dir,speaker_wav,threshold}
        (streaming_server.py:192-196).
    Vad.Webrtc has no knob here by design: the first-stage gate runs
    ON DEVICE (energy gate + Silero, models/serving.py); the native GMM
    frame VAD (models/frame_vad.py) is the host-side parity tool."""
    # the reference layout cannot express framework serving keys; adopt
    # the shipped production posture (configs/server-vi.yaml) unless the
    # file overrides them explicitly
    if "device_worker" not in blob:
        s.device_worker = True
    if "scheduler_groups" not in blob:
        s.scheduler_groups = 2

    model_dir = blob.get("model_dir")
    cfg_dir = os.path.dirname(os.path.abspath(config_path)) \
        if config_path else None
    deploy_root = os.path.dirname(os.path.dirname(model_dir)) \
        if model_dir else None

    am = blob.get("Acoustic_Model") or {}
    if s.language != "en" and not s.checkpoint and am.get("filepath") \
            and model_dir:
        s.checkpoint = _existing_path(
            [os.path.join(model_dir, am["filepath"])], "checkpoint (vi AM)")
    if s.language == "en" and model_dir:
        rnnt_dir = os.path.join(os.path.dirname(model_dir), "emformer-rnnt")
        if not s.checkpoint:
            s.checkpoint = _existing_path(
                [os.path.join(rnnt_dir, "emformer_rnnt.pt")],
                "checkpoint (en RNNT)")
        if not s.vocab_path:
            s.vocab_path = _existing_path(
                [os.path.join(rnnt_dir, "spm_bpe_4096.model")],
                "vocab_path (en SPM)")
        if not s.en_global_stats:
            s.en_global_stats = _existing_path(
                [os.path.join(rnnt_dir, "global_stats_rnnt.json")],
                "en_global_stats")

    ling = blob.get("Linguistic_Model") or {}
    # the reference instantiates ONE BeamSearchDecoder per named key and
    # selects per stream via stream.sw_model (streaming_server.py:165-169,
    # 511-513); load the whole registry.  GENERAL (or the first key) also
    # populates the flat lexicon_path/lm_path fields for the single-LM
    # fast path; a nulled section degrades instead of crashing.
    corpus = blob.get("corpus_dir")
    for name, lm_cfg in ling.items():
        if not isinstance(lm_cfg, dict):
            continue
        entry: Dict[str, Any] = {}
        if lm_cfg.get("lexicon"):
            entry["lexicon_path"] = _existing_path(
                [os.path.join(corpus, lm_cfg["lexicon"]) if corpus else None,
                 lm_cfg["lexicon"]], f"lexicon_path ({name})")
        if lm_cfg.get("lm"):
            entry["lm_path"] = _existing_path(
                [os.path.join(corpus, lm_cfg["lm"]) if corpus else None,
                 lm_cfg["lm"]], f"lm_path ({name})")
        for key in ("lm_weight", "beam_size", "beam_size_token",
                    "beam_threshold", "word_score"):
            if key in lm_cfg:
                entry[key] = lm_cfg[key]
        s.lm_models[name] = entry
    lm_cfg = (s.lm_models["GENERAL"] if "GENERAL" in s.lm_models
              else next(iter(s.lm_models.values()), {}))
    if lm_cfg:
        if lm_cfg.get("lexicon_path") and not s.lexicon_path:
            s.lexicon_path = lm_cfg["lexicon_path"]
        if lm_cfg.get("lm_path") and not s.lm_path:
            s.lm_path = lm_cfg["lm_path"]
        for key in ("lm_weight", "beam_size", "beam_size_token",
                    "beam_threshold", "word_score"):
            # explicit top-level framework keys win over the mapped
            # section (the documented overlay contract)
            if key in lm_cfg and key not in blob:
                setattr(s, key, lm_cfg[key])
    if isinstance(blob.get("Mapping_rule"), dict):
        # model name -> endpoint ruleset name (reference stream.py:61,139)
        s.mapping_rule = dict(blob["Mapping_rule"])

    if blob.get("LM_Endpointing") and not s.lm_endpointing_path:
        s.lm_endpointing_path = _existing_path(
            [blob["LM_Endpointing"]], "lm_endpointing_path")

    silero = (blob.get("Vad") or {}).get("Silero") or {}
    if silero.get("model_path") and not s.vad_weights:
        p = silero["model_path"]
        s.vad_weights = _existing_path(
            [p,
             os.path.join(cfg_dir, p) if cfg_dir else None,
             os.path.join(deploy_root, p) if deploy_root else None],
            "vad_weights (silero onnx)")
        if s.vad_weights:
            s.use_silero = True

    diar = blob.get("Speaker_Diar") or {}
    if diar.get("model_dir"):
        if not s.speaker_weights:
            s.speaker_weights = _existing_path(
                [os.path.join(diar["model_dir"], "embedding_model.ckpt")],
                "speaker_weights (ECAPA)")
        if diar.get("speaker_wav") and not s.speaker_wav:
            s.speaker_wav = _existing_path(
                [os.path.join(diar["model_dir"], diar["speaker_wav"])],
                "speaker_wav")
    if "threshold" in diar and "speaker_threshold" not in blob:
        s.speaker_threshold = diar["threshold"]


@dataclasses.dataclass
class ServerSettings:
    language: str = "vi"
    port: int = 6006
    max_active_connections: int = 512
    send_internal: bool = True
    save_audio: bool = False
    filter_noise: bool = False
    noise_threshold_db: float = -40.0
    compute_dtype: str = "bfloat16"
    checkpoint: Optional[str] = None
    corpus_dir: Optional[str] = None           # dir with vocab.txt/lexicon.txt
    vocab_path: Optional[str] = None
    lexicon_path: Optional[str] = None
    lm_path: Optional[str] = None              # ARPA for beam rescoring
    lm_endpointing_path: Optional[str] = None  # ARPA for endpoint cost
    vad_weights: Optional[str] = None
    doc_root: Optional[str] = None
    certificate: Optional[str] = None
    norm_url: Optional[str] = None             # text normalizer sidecar
    speaker_wav: Optional[str] = None
    speaker_threshold: float = 0.45
    speaker_weights: Optional[str] = None  # ECAPA npz (tools/convert_ecapa)
                                           # or raw embedding_model.ckpt
    en_global_stats: Optional[str] = None  # reference global_stats_rnnt.json
                                           # (EN feature normalization,
                                           # recognition.py:107)
    audio: AudioConfig = dataclasses.field(default_factory=lambda: VI_AUDIO)
    endpoint_rules: Dict = dataclasses.field(
        default_factory=lambda: VI_DEFAULT_RULES)
    # Multi-LM registry (reference streaming_server.py:165-169): named
    # rescorer configs, each entry {lexicon_path, lm_path, lm_weight,
    # beam_size, beam_size_token, beam_threshold, word_score}.  Empty
    # means single-LM mode via the flat lexicon_path/lm_path fields.
    lm_models: Dict = dataclasses.field(default_factory=dict)
    # Named endpoint rulesets (reference asr-online.yaml Endpointing_rules
    # keys) and the model-name -> ruleset-name map (Mapping_rule,
    # reference stream.py:61,139).  endpoint_rules stays the DEFAULT set.
    endpoint_rulesets: Dict = dataclasses.field(default_factory=dict)
    mapping_rule: Dict = dataclasses.field(
        default_factory=lambda: {"GENERAL": "DEFAULT"})
    use_silero: bool = True
    upload_encoding: str = "mulaw"   # "int16" | "mulaw" (halved tick bytes)
    quant: str = "none"              # "int8" | "int8_ffn": W8A8 products
                                     # in the Emformer kernels (A, C)
    scheduler_groups: int = 1        # slot groups ticked round-robin;
                                     # raise on low-RTT (local PCIe) hosts
                                     # for lower per-chunk latency
    data_parallel: int = 1           # chips to shard the slot axis over
                                     # (0 = all local chips); multi-chip
                                     # serving via parallel/serving.py
    device_worker: bool = False      # run the serving step in a spawned
                                     # device process (GIL + event-loop
                                     # isolation; streaming/device_worker)
    en_beam_partials: bool = False   # EN: carried-hypothesis beam per chunk
    en_beam_width: int = 10
    en_beam_impl: str = "device"     # "device": batched on-device beam
                                     # (models/rnnt_beam.py, scales to full
                                     # slot counts); "host": per-stream
                                     # oracle loop (parity/debug only)
    lm_weight: float = 1.0
    beam_size: int = 50
    beam_size_token: int = 5
    beam_threshold: float = 50.0
    word_score: float = 0.5

    @classmethod
    def load(cls, path: Optional[str] = None,
             env: Optional[dict] = None) -> "ServerSettings":
        env = env if env is not None else os.environ
        blob: Dict[str, Any] = {}
        if path:
            with open(path) as f:
                blob = yaml.safe_load(f) or {}

        s = cls()
        s.language = env.get("LANGUAGE", blob.get("language", s.language))
        s.port = int(env.get("PORT", blob.get("port", s.port)))
        if s.language == "en":
            s.audio = EN_AUDIO
            s.endpoint_rules = EN_DEFAULT_RULES
        for key in ("send_internal", "save_audio", "filter_noise",
                    "compute_dtype", "checkpoint", "corpus_dir", "vocab_path",
                    "lexicon_path", "lm_path", "lm_endpointing_path",
                    "vad_weights", "doc_root", "certificate", "speaker_wav",
                    "speaker_weights", "en_global_stats",
                    "use_silero", "upload_encoding", "quant",
                    "en_beam_partials", "en_beam_impl",
                    "en_beam_width", "scheduler_groups", "data_parallel",
                    "device_worker",
                    "lm_weight", "beam_size", "beam_size_token",
                    "beam_threshold", "word_score",
                    "max_active_connections"):
            if key in blob:
                setattr(s, key, blob[key])
        if "noise_threashold" in blob:     # reference's (sic) key
            s.noise_threshold_db = blob["noise_threashold"]
        if "noise_threshold_db" in blob:
            s.noise_threshold_db = blob["noise_threshold_db"]
        if "speaker_threshold" in blob:
            s.speaker_threshold = blob["speaker_threshold"]
        if any(k in blob for k in _REFERENCE_MARKERS):
            _apply_reference_layout(s, blob, path)
        a = blob.get("audio")
        if s.language == "en" and "audio_en" in blob:
            # the reference keeps BOTH geometries in one file and switches
            # on LANGUAGE (asr-online.yaml:112-126 audio/audio_en)
            a = blob["audio_en"]
        if a:
            s.audio = AudioConfig(
                sample_rate=a.get("sample_rate", 16000),
                hop_seconds=a.get("hop_length", 0.01),
                segment_size=a.get("segment_size", 64),
                context_size=a.get("context_size", 16),
                bias=a.get("bias", 4),
                framerate=a.get("framerate", 4))
        if "Endpointing_rules" in blob:
            # reference layout: {ruleset: {rule: {...}}} — EVERY named
            # ruleset loads (stream.py:62-64 builds EndpointingRule per
            # key); endpoint_rules keeps the DEFAULT (or first) set for
            # streams whose sw_model maps nowhere
            rules = blob["Endpointing_rules"]
            for name, ruleset in rules.items():
                ruleset = {k: {kk: (math.inf if vv == ".inf" else vv)
                               for kk, vv in v.items()}
                           for k, v in ruleset.items()}
                s.endpoint_rulesets[name] = load_endpoint_rules(ruleset)
            # key-presence check, not truthiness: an explicitly EMPTY
            # DEFAULT set (rule-based endpointing disabled) must win
            # over other named sets
            s.endpoint_rules = (
                s.endpoint_rulesets["DEFAULT"]
                if "DEFAULT" in s.endpoint_rulesets
                else next(iter(s.endpoint_rulesets.values())))
        if "endpoint_rules" in blob:
            s.endpoint_rules = load_endpoint_rules(blob["endpoint_rules"])
        if isinstance(blob.get("endpoint_rulesets"), dict):
            # framework layout twin of Endpointing_rules
            for name, ruleset in blob["endpoint_rulesets"].items():
                s.endpoint_rulesets[name] = load_endpoint_rules(ruleset)
        if isinstance(blob.get("lm_models"), dict):
            # framework layout twin of Linguistic_Model: already-resolved
            # {name: {lexicon_path, lm_path, ...}} entries
            for name, entry in blob["lm_models"].items():
                if isinstance(entry, dict):
                    s.lm_models[name] = dict(entry)
        if isinstance(blob.get("mapping_rule"), dict):
            s.mapping_rule = dict(blob["mapping_rule"])
        if "endpoint_rules" in blob and s.endpoint_rulesets:
            # Stream looks up rulesets[mapping_rule[sw_model]] before the
            # flat rules: the flat override must replace the DEFAULT set
            s.endpoint_rulesets["DEFAULT"] = s.endpoint_rules
        norm_port = env.get("NORM_PORT")
        if norm_port and not s.norm_url:
            s.norm_url = f"http://localhost:{norm_port}/cleanoutput"
        if "norm_url" in blob:
            s.norm_url = blob["norm_url"]
        return s

    def ngram_cost(self) -> NgramEndpointCost:
        if self.lm_endpointing_path and os.path.exists(
                self.lm_endpointing_path):
            return NgramEndpointCost.from_arpa(self.lm_endpointing_path)
        return NgramEndpointCost()
