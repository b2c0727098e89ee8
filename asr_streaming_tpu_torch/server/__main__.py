"""Server entry point: ``python -m asr_streaming_tpu_torch.server``.

Counterpart of asr_streaming_tpu/server/__main__.py, with the same flags
and environment (PORT, LANGUAGE, NORM_PORT) over the same YAML configs:

    python -m asr_streaming_tpu_torch.server --config configs/server-vi.yaml \\
        --port 6006 --allow-random-weights

The serving step runs on the CUDA card: in a spawned device-worker child
with ``device_worker: true`` (the shipped configs; this process then keeps
only host work and never creates a CUDA context), else on a tick thread
in this process.  The route (kernel A's stack by default) and ``quant``
are decided here once and reach the child inside the pickled
ServingConfig.  A kernel that does not build or launch fails the warm-up,
and the process exits non-zero.  SIGINT or SIGTERM drains the server: the
tick thread stops, the worker's kernel launch counts are logged, the
child is joined, and the process exits 0.

``checkpoint:`` takes an ``.npz`` (possibly partial) or a reference
``.ckpt``/``.pt``, converted at load (utils/checkpoint.py::
load_params_auto), here and in the worker child alike.  ``speaker_wav``
enrolls a speaker: ECAPA (models/ecapa.py, ``speaker_weights`` as
``.npz``, ``.ckpt`` or ``.pt``, else random weights with a warning) runs
on the card in this process, so this process opens a CUDA context only
when ``speaker_wav`` is set, and every final with a word window carries
its ``is_speaker``.  ``data_parallel`` 0 (every card) or ``n > 1``
splits the scheduler's slots over the local cards (parallel/serving.py)
when the step runs in this process; with ``device_worker: true`` the
child owns the card, so the setting is dropped with a warning, as the
JAX server does.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import logging
import os
import sys
import threading


def _check_ported(settings) -> None:
    """Raise on a setting the port cannot serve.  Every setting of the
    JAX server is ported; ``data_parallel`` must count cards (0: all)."""
    if settings.data_parallel < 0:
        raise ValueError(f"data_parallel: {settings.data_parallel}: the "
                         "number of cards to split the slots over (0: all)")


def build_config(settings, vocab_size=None):
    """The ServingConfig that ``settings`` describe: the model, its
    kernel route (with_kernel_route / emformer_route, kernel A's stack by
    default) and ``quant``, the VAD and the upload encoding.  ``vocab_size``
    sizes the Vietnamese CTC head when a corpus vocab is served."""
    import torch

    from asr_streaming_tpu_torch.models.asr import (
        ASRConfig, emformer_route, with_kernel_route,
    )
    from asr_streaming_tpu_torch.models.serving import ServingConfig

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        settings.compute_dtype]
    if settings.language == "en":
        # English path: Emformer-RNNT, its transcriber on kernel A
        from asr_streaming_tpu_torch.models.rnnt import (
            RNNTConfig, rnnt_config_for_audio,
        )
        rnnt_cfg = RNNTConfig()
        rnnt_cfg = dataclasses.replace(rnnt_cfg, emformer=emformer_route(
            dataclasses.replace(rnnt_cfg.emformer, compute_dtype=dtype),
            "stack", settings.quant))
        # the transcriber's segment follows the audio geometry
        rnnt_cfg = rnnt_config_for_audio(rnnt_cfg, settings.audio)
        asr_cfg = dataclasses.replace(ASRConfig.vietnamese(dtype),
                                      audio=settings.audio)
        cfg = ServingConfig(asr=asr_cfg, model_kind="rnnt", rnnt=rnnt_cfg,
                            use_silero=settings.use_silero,
                            upload_encoding=settings.upload_encoding,
                            en_global_stats=settings.en_global_stats)
    else:
        asr_cfg = dataclasses.replace(ASRConfig.vietnamese(dtype),
                                      audio=settings.audio)
        asr_cfg = with_kernel_route(asr_cfg, "stack", settings.quant)
        if vocab_size is not None:
            # the CTC head is sized by the served vocab
            asr_cfg = dataclasses.replace(
                asr_cfg,
                encoder=dataclasses.replace(asr_cfg.encoder,
                                            vocab_size=vocab_size))
        cfg = ServingConfig(asr=asr_cfg, use_silero=settings.use_silero,
                            upload_encoding=settings.upload_encoding)
    return cfg


def build_server(settings, max_slots=None, device=None):
    """The StreamingServer that ``settings`` describe.  ``device`` follows
    ``resolve_device``: CUDA unless the caller names the CPU (the tests
    do); without CUDA it raises."""
    import torch

    from asr_streaming_tpu_torch import resolve_device
    from asr_streaming_tpu_torch.models.serving import init_serving_params
    from asr_streaming_tpu_torch.models.vad import load_vad_weights
    from asr_streaming_tpu_torch.server.ws_server import StreamingServer
    from asr_streaming_tpu_torch.streaming.scheduler import (
        GroupedScheduler, Scheduler,
    )
    from asr_streaming_tpu_torch.text.corpus import corpus_paths
    from asr_streaming_tpu_torch.text.vocab import (
        load_vocab, placeholder_vocab,
    )
    from asr_streaming_tpu_torch.utils.checkpoint import (
        load_params_auto, overlay_params,
    )

    _check_ported(settings)
    device = resolve_device(device)
    worker = settings.device_worker
    if worker:
        logging.info("device_worker: serving step in a child process on "
                     "%s; this process keeps the host work", device)

    # the corpus (vocab + lexicon) of the vi path: ASR_CORPUS_DIR, config
    # or assets/corpus
    vocab = None
    if settings.vocab_path:
        if settings.vocab_path.endswith(".model"):
            # SentencePiece model (EN path; reference recognition.py:119)
            from asr_streaming_tpu_torch.text.spm import load_spm_pieces
            vocab = load_spm_pieces(settings.vocab_path)
        else:
            vocab = load_vocab(settings.vocab_path)
    elif settings.language != "en":
        paths = corpus_paths(settings.corpus_dir)
        if "vocab" in paths:
            vocab = load_vocab(paths["vocab"])
            logging.info("loaded corpus vocab (%d tokens) from %s",
                         len(vocab), paths["vocab"])
        if not settings.lexicon_path and "lexicon" in paths:
            settings.lexicon_path = paths["lexicon"]

    cfg = build_config(settings,
                       len(vocab) if vocab is not None else None)

    # Final rescoring upgrades GREEDY-partial EN finals to beam quality; in
    # beam-partials mode the final text already is the carried beam
    # hypothesis (the reference's contract), so there is no EN rescorer.
    en_rescore = cfg.model_kind == "rnnt" and not settings.en_beam_partials
    # In worker mode the child rebuilds the weights from (seed 0,
    # checkpoint, vad_weights); this process needs them only for the EN
    # rescorer, and then keeps them on the CPU.
    params = None
    if not worker or en_rescore:
        params = init_serving_params(
            0, cfg, torch.device("cpu") if worker else device)
        if settings.checkpoint:
            # .npz (possibly partial) or a reference .ckpt / .pt,
            # converted at load
            params = load_params_auto(settings.checkpoint, like=params)
            logging.info("loaded checkpoint %s", settings.checkpoint)
        if settings.vad_weights and not worker:
            params = overlay_params(
                params, {"vad": load_vad_weights(settings.vad_weights, cfg)})
            logging.info("loaded Silero VAD weights from %s",
                         settings.vad_weights)
    if settings.checkpoint and worker:
        logging.info("checkpoint %s loads in the device-worker child",
                     settings.checkpoint)
    elif not settings.checkpoint:
        logging.warning("no checkpoint configured — serving random weights")

    if vocab is None:
        size = (cfg.rnnt.vocab_size if cfg.model_kind == "rnnt"
                else cfg.asr.encoder.vocab_size)
        vocab = placeholder_vocab(size)
        logging.warning("no corpus vocab found — using placeholder vocab")

    slots = max_slots or settings.max_active_connections
    sched_kwargs = dict(
        language=settings.language,
        rules=settings.endpoint_rules,
        rulesets=settings.endpoint_rulesets,
        mapping_rule=settings.mapping_rule,
        ngram_cost=settings.ngram_cost(),
        en_beam_partials=settings.en_beam_partials,
        en_beam_width=settings.en_beam_width,
        en_beam_impl=settings.en_beam_impl)
    dp = settings.data_parallel
    if dp != 1 and worker:
        logging.warning("device_worker is exclusive with data_parallel — "
                        "data_parallel ignored")
    elif dp != 1:
        # multi-GPU serving: the slot axis split over the local cards
        # (parallel/serving.py); 0 means all of them
        from asr_streaming_tpu_torch.parallel.serving import (
            make_serving_mesh,
        )
        sched_kwargs["mesh"] = make_serving_mesh(dp, device=device)
        logging.info("serving data-parallel over %d shards: %s",
                     sched_kwargs["mesh"].shape["data"],
                     [str(d) for d in sched_kwargs["mesh"].devices])
    if worker:
        if settings.en_beam_partials and settings.en_beam_impl == "host":
            logging.warning("en_beam_partials host impl needs in-process "
                            "device access — switching to the device beam "
                            "for device_worker mode")
            sched_kwargs["en_beam_impl"] = "device"
        sched_kwargs["device_worker"] = dict(
            seed=0, checkpoint=settings.checkpoint,
            vad_weights=settings.vad_weights, device=str(device))
    elif "mesh" not in sched_kwargs:
        sched_kwargs["device"] = device
    groups = settings.scheduler_groups
    if groups > 1 or worker:
        # with device_worker all groups multiplex through ONE child
        scheduler = GroupedScheduler(params, cfg, vocab, max_slots=slots,
                                     groups=groups, **sched_kwargs)
    else:
        scheduler = Scheduler(params, cfg, vocab, max_slots=slots,
                              **sched_kwargs)

    def _build_rescorer(lexicon_path, lm_path, **kwargs):
        from asr_streaming_tpu_torch.decode.beam_native import (
            make_native_rescorer,
        )
        r = make_native_rescorer(vocab, lexicon_path, lm_path, **kwargs)
        if r is None:   # no C++ compiler: the Python beam
            from asr_streaming_tpu_torch.decode.beam import make_rescorer
            logging.warning("no C++ compiler: finals use the Python beam")
            r = make_rescorer(vocab, lexicon_path, lm_path, **kwargs)
        return r

    base_lm_kwargs = dict(
        lm_weight=settings.lm_weight, beam_size=settings.beam_size,
        beam_size_token=settings.beam_size_token,
        beam_threshold=settings.beam_threshold,
        word_score=settings.word_score)
    rescorer = None
    if settings.lexicon_path and settings.lm_path:
        rescorer = _build_rescorer(settings.lexicon_path, settings.lm_path,
                                   **base_lm_kwargs)
    # the Linguistic_Model registry: one named rescorer per entry, each
    # entry's own lm_weight/beam knobs over the flat defaults
    rescorers = {}
    for name, entry in (settings.lm_models or {}).items():
        lex = entry.get("lexicon_path") or settings.lexicon_path
        lm = entry.get("lm_path") or settings.lm_path
        if not (lex and lm):
            logging.warning("lm model %s: missing lexicon/lm — skipped",
                            name)
            continue
        kw = dict(base_lm_kwargs)
        kw.update({k: entry[k] for k in base_lm_kwargs if k in entry})
        if (lex, lm) == (settings.lexicon_path, settings.lm_path) and \
                kw == base_lm_kwargs and rescorer is not None:
            rescorers[name] = rescorer     # share the already-built one
        else:
            rescorers[name] = _build_rescorer(lex, lm, **kw)
    if rescorers:
        logging.info("Loaded LM models: %s", sorted(rescorers))
        if rescorer is None:
            rescorer = rescorers.get("GENERAL") or \
                next(iter(rescorers.values()))

    normalizer = None
    if settings.norm_url:
        import urllib.parse
        import urllib.request

        def normalizer(text: str) -> str:
            # reference utils.py:52-57 (incl. the phantram -> % fixup)
            data = urllib.parse.urlencode({"text": text}).encode()
            try:
                with urllib.request.urlopen(settings.norm_url, data=data,
                                            timeout=5) as r:
                    return r.read().decode().replace("phantram", "%")
            except Exception:
                logging.exception("normalizer call failed")
                return text

    en_rescorer = None
    if en_rescore:
        from asr_streaming_tpu_torch.models.rnnt import make_rnnt_rescorer
        en_rescorer = make_rnnt_rescorer(params, cfg.rnnt, vocab)

    return StreamingServer(
        scheduler, rescorer=rescorer, rescorers=rescorers,
        normalizer=normalizer,
        en_rescorer=en_rescorer,
        speaker_verifier=build_speaker_verifier(settings, device),
        doc_root=settings.doc_root, certificate=settings.certificate,
        send_internal=settings.send_internal,
        filter_noise=settings.filter_noise,
        noise_threshold_db=settings.noise_threshold_db,
        save_audio_dir="audio_cache" if settings.save_audio else None)


def build_speaker_verifier(settings, device):
    """The enrolled speaker's SpeakerVerifier on ``device`` (this process's;
    the device worker does not hold it), or None without ``speaker_wav``.
    Logs its device, the seconds its construction took (the CUDA context,
    the weights, one embedding per bucket) and the device memory it
    holds."""
    if not settings.speaker_wav:
        return None
    import time

    import torch

    from asr_streaming_tpu_torch.models.ecapa import (
        EcapaConfig, SpeakerVerifier, init_ecapa_params, load_ecapa_weights,
    )
    from asr_streaming_tpu_torch.utils.audio import read_wav

    t0 = time.perf_counter()
    ecfg = EcapaConfig()
    if settings.speaker_weights:
        eparams = load_ecapa_weights(settings.speaker_weights, ecfg)
        logging.info("loaded ECAPA speaker weights from %s",
                     settings.speaker_weights)
    else:
        # a random-init verifier still exercises the pipeline end to end,
        # but is_speaker is noise — ship speaker_weights in production
        eparams = init_ecapa_params(1, ecfg, "cpu")
        logging.warning("speaker verification running with RANDOM ECAPA "
                        "weights (set speaker_weights:)")
    wave, _sr = read_wav(settings.speaker_wav)
    verifier = SpeakerVerifier(eparams, ecfg, wave,
                               threshold=settings.speaker_threshold,
                               device=device)
    mib = (torch.cuda.memory_reserved(verifier.device) / 2 ** 20
           if verifier.device.type == "cuda" else 0.0)
    logging.info("speaker verifier on %s: built in %.2f s, %.1f MiB "
                 "reserved on the device", verifier.device,
                 time.perf_counter() - t0, mib)
    return verifier


def launch_counts(scheduler) -> dict:
    """Kernel launches of the serving step so far: the device-worker
    child's, or this process's."""
    client = getattr(scheduler, "client", None)
    if client is not None:
        return client.stats()["launches"]
    from asr_streaming_tpu_torch.ops import _cuda
    return _cuda.launch_counts()


def install_graceful_signals() -> None:
    """Route SIGINT and SIGTERM into KeyboardInterrupt on the main thread.

    Backgrounded children of non-interactive shells inherit SIGINT=SIG_IGN
    (python then installs no KeyboardInterrupt handler) and orchestrators
    send SIGTERM; signal.signal overrides both, and handlers run on the
    main thread, which main() parks in a join loop, so the drain branch
    always runs."""
    import signal

    def _graceful(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGINT, _graceful)
    signal.signal(signal.SIGTERM, _graceful)


def _shutdown(server) -> None:
    """Stop the tick thread, log the kernel launches, close the scheduler
    (its device-worker child is joined)."""
    server.stop_ticks()
    try:
        logging.info("kernel launches: %s",
                     json.dumps(launch_counts(server.scheduler)))
    finally:
        server.scheduler.close()


def main():
    from asr_streaming_tpu_torch.server.config import ServerSettings
    from asr_streaming_tpu_torch.utils.logs import setup_logger

    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, default=None)
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("PORT", 6006)))
    parser.add_argument("--max-active-connections", type=int, default=None)
    parser.add_argument("--max-message-size", type=int, default=1 << 20)
    parser.add_argument("--max-queue-size", type=int, default=32)
    parser.add_argument("--certificate", type=str, default=None)
    parser.add_argument("--doc-root", type=str, default=None)
    parser.add_argument("--log-dir", type=str, default="logs")
    parser.add_argument("--allow-random-weights", action="store_true",
                        help="boot with no checkpoint (serves random-"
                             "weight gibberish; dev/bench only)")
    args = parser.parse_args()

    setup_logger(args.log_dir)   # rotating debug.log + INFO console
    settings = ServerSettings.load(args.config)

    # A config without a checkpoint must not silently serve random-weight
    # gibberish: adopt a bootstrap overlay beside the config
    # (server-vi.yaml -> server-vi.local.yaml) or require the opt-in flag.
    if not settings.checkpoint and args.config:
        stem, ext = os.path.splitext(args.config)
        overlay = f"{stem}.local{ext or '.yaml'}"
        if os.path.exists(overlay):
            logging.info("no checkpoint in %s — adopting bootstrap "
                         "overlay %s", args.config, overlay)
            settings = ServerSettings.load(overlay)
    if not settings.checkpoint and not args.allow_random_weights:
        parser.exit(2, (
            f"error: {args.config or 'the default config'} configures no "
            "checkpoint, and no bootstrap overlay was found beside it — "
            "a boot now would serve random-weight gibberish.\n"
            "Either convert your deploy tree's assets first:\n"
            "    python tools/bootstrap_assets.py --tree "
            "/path/to/reference/deploy --out assets/\n"
            "(writes converted weights + a ready server-*.local.yaml "
            "overlay), or pass --allow-random-weights for a weightless "
            "dev/bench boot.\n"))
    if args.certificate:
        settings.certificate = args.certificate
    if args.doc_root:
        settings.doc_root = args.doc_root
    if args.max_active_connections:
        settings.max_active_connections = args.max_active_connections

    server = build_server(settings)
    server.max_message_size = args.max_message_size
    server.max_queue_size = args.max_queue_size

    # the asyncio loop runs on a secondary thread; the main thread parks
    # in a join loop where the signal handlers raise
    failure = []

    def loop_main():
        try:
            asyncio.run(server.run(args.port))
        except BaseException as e:   # noqa: BLE001 — reported via exit code
            failure.append(e)

    install_graceful_signals()
    t = threading.Thread(target=loop_main, name="asyncio-loop", daemon=True)
    t.start()
    try:
        while t.is_alive():
            t.join(timeout=1.0)
    except KeyboardInterrupt:
        logging.info("interrupted — shutting down")
        _shutdown(server)
        logging.info("shut down")
        return
    logging.error("server loop failed",
                  exc_info=failure[0] if failure else None)
    server.stop_ticks()
    server.scheduler.close()
    sys.exit(1)


if __name__ == "__main__":
    main()
