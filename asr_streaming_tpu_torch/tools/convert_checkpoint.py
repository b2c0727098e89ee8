"""Convert reference torch checkpoints to this framework's npz params.

Copied from asr_streaming_tpu/tools/convert_checkpoint.py; it writes the
``.npz`` both packages read.

Migration path for users of the reference stack: its Vietnamese model is
a Lightning checkpoint holding ``hyper_parameters`` + split
``state_dict['encoder'/'decoder']`` weights (reference:
lightspeech/models/recognition.py:149-159), with the torchaudio Emformer
parameter naming.  This tool maps those tensors onto our parameter tree
(models/encoder.py + models/emformer.py) and writes the npz the server's
``checkpoint:`` config key loads.

  python -m asr_streaming_tpu_torch.tools.convert_checkpoint \
      asr-online.ckpt out_params.npz

Shape conventions translated:
  * torch Linear stores [out, in]; we store [in, out]  -> transpose
  * per-layer Emformer modules -> stacked [L, ...] arrays
  * emb_to_key_value -> w_kv [D, 2D]; pos_ff.{1,4} -> ff_w1/ff_w2
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _t(x) -> np.ndarray:
    """torch tensor -> numpy, Linear weights transposed to [in, out]."""
    arr = np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                     else x)
    return arr


def convert_encoder_state_dict(enc_sd: Mapping[str, "object"],
                               num_layers: int = 20) -> Dict:
    """Map the reference StreamingAcousticEncoder state_dict (torchaudio
    Emformer naming, modules/encoder.py:99-117) onto our encoder params."""
    sd = {k: _t(v) for k, v in enc_sd.items()}

    def lin_w(name):
        return sd[name].T.astype(np.float32)

    def vec(name):
        return sd[name].astype(np.float32)

    layers = []
    for i in range(num_layers):
        p = f"encoder_layers.emformer_layers.{i}."
        layers.append({
            "w_kv": lin_w(p + "attention.emb_to_key_value.weight"),
            "b_kv": vec(p + "attention.emb_to_key_value.bias"),
            "w_q": lin_w(p + "attention.emb_to_query.weight"),
            "b_q": vec(p + "attention.emb_to_query.bias"),
            "w_out": lin_w(p + "attention.out_proj.weight"),
            "b_out": vec(p + "attention.out_proj.bias"),
            "ln_in_scale": vec(p + "layer_norm_input.weight"),
            "ln_in_bias": vec(p + "layer_norm_input.bias"),
            # pos_ff = Sequential(LayerNorm, Linear, act, Dropout, Linear,
            # Dropout) (reference emformer.py:260-267)
            "ff_ln_scale": vec(p + "pos_ff.0.weight"),
            "ff_ln_bias": vec(p + "pos_ff.0.bias"),
            "ff_w1": lin_w(p + "pos_ff.1.weight"),
            "ff_b1": vec(p + "pos_ff.1.bias"),
            "ff_w2": lin_w(p + "pos_ff.4.weight"),
            "ff_b2": vec(p + "pos_ff.4.bias"),
            "ln_out_scale": vec(p + "layer_norm_output.weight"),
            "ln_out_bias": vec(p + "layer_norm_output.bias"),
        })
    emformer = {k: np.stack([l[k] for l in layers]) for k in layers[0]}
    return {
        "input_linear": {"w": lin_w("input_linear.weight")},
        "emformer": emformer,
    }


def convert_ctc_state_dict(dec_sd: Mapping[str, "object"]) -> Dict:
    """CTCDecoder(linear1, linear2) (reference decoder.py:60-70)."""
    sd = {k: _t(v) for k, v in dec_sd.items()}
    return {
        "w1": sd["linear1.weight"].T.astype(np.float32),
        "b1": sd["linear1.bias"].astype(np.float32),
        "w2": sd["linear2.weight"].T.astype(np.float32),
        "b2": sd["linear2.bias"].astype(np.float32),
    }


def convert_lightning_checkpoint(ckpt_path: str, out_path: str,
                                 num_layers: int = 20) -> dict:
    """Full conversion of the reference's asr-online.ckpt."""
    import torch
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    weights = blob["state_dict"]
    enc_sd = weights["encoder"] if "encoder" in weights else {
        k[len("encoder."):]: v for k, v in weights.items()
        if k.startswith("encoder.")}
    dec_sd = weights["decoder"] if "decoder" in weights else {
        k[len("decoder."):]: v for k, v in weights.items()
        if k.startswith("decoder.")}

    params = {
        "encoder": {**convert_encoder_state_dict(enc_sd, num_layers),
                    "ctc": convert_ctc_state_dict(dec_sd)},
    }
    save_params(out_path, params)
    return params


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint")
    parser.add_argument("output")
    parser.add_argument("--num-layers", type=int, default=20)
    args = parser.parse_args()
    convert_lightning_checkpoint(args.checkpoint, args.output,
                                 args.num_layers)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
