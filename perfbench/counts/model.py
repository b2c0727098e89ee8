"""Model operations of one chunk of one stream (2 per multiply-add), from
the configuration's shapes: what ``mfu_pct`` counts.  Products only:
the frontend's DFT and mel products, ``input_linear``, the Emformer
(``counts/emformer.py``), and the CTC head, or the transcriber's output
projection with the device beam's joiner and predictor."""

from perfbench.counts.emformer import stack_flops, stack_geometry


def _frontend(model: dict) -> float:
    mel, a = model["mel"], model["audio"]
    samples = a["buffer_length"] + a["segment_length"]
    if mel["center"]:
        frames = 1 + samples // mel["hop_length"]
    else:
        frames = 1 + (samples - mel["n_fft"]) // mel["hop_length"]
    F2 = 2 * (mel["n_fft"] // 2 + 1)
    return 2.0 * frames * (mel["n_fft"] * F2 + F2 // 2 * mel["n_mels"])


def chunk_flops(model: dict) -> float:
    em = model["emformer"]
    U, R = em["segment_length"], em["right_context_length"]
    reduced = 4 * (U + R)                   # mel frames into input_linear
    enc = stack_flops(*stack_geometry(em, 1))
    total = _frontend(model) + enc
    if model["kind"] == "ctc":
        D, H, V = model["d_model"], model["ctc_hidden_dim"], model["vocab_size"]
        total += 2.0 * reduced * model["n_mels"] * (D // 4)
        return total + 2.0 * U * (D * H + H * V)
    D, E, V = model["d_model"], model["encoding_dim"], model["vocab_size"]
    total += 2.0 * reduced * model["n_mels"] * model["input_linear_dim"]
    total += 2.0 * U * D * E
    W, K = model["beam_width"], model["max_symbols_per_frame"]
    H, Pe, nl = model["pred_hidden"], model["pred_embed_dim"], model["pred_layers"]
    pred = 2.0 * (Pe * 4 * H + (nl - 1) * H * 4 * H + nl * H * 4 * H + H * E)
    return total + U * ((K + 1) * W * 2.0 * E * V + K * W * pred)
