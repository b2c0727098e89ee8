"""Convert a torchaudio ``emformer_rnnt_base`` checkpoint to framework npz.

Copied from asr_streaming_tpu/tools/convert_rnnt_checkpoint.py; it writes the
``.npz`` both packages read.

Migration path for the reference's English model: it loads a torchaudio
RNN-T ``.pt`` state dict (reference: lightspeech/models/recognition.py:
112-115 — ``emformer_rnnt_base(num_symbols=4097)`` +
``load_state_dict(torch.load(...))``).  This tool maps that state dict
onto our parameter tree (models/rnnt.py) and writes the npz the EN
server's ``checkpoint:`` config key loads.

  python -m asr_streaming_tpu_torch.tools.convert_rnnt_checkpoint \
      emformer_rnnt_base.pt out_params.npz

torchaudio module -> framework mapping (Linear weights transposed
[out,in] -> [in,out]):

  transcriber.input_linear.weight (no bias)    -> input_linear.w
  transcriber.transformer.emformer_layers.{i}. -> emformer.* stacked [L,...]
      attention.emb_to_query / emb_to_key_value / out_proj
      layer_norm_input / pos_ff.{0,1,4} / layer_norm_output
  transcriber.output_linear + layer_norm       -> enc_out.*
  predictor.embedding.weight                   -> predictor.embedding
  predictor.input_layer_norm                   -> predictor.input_ln_*
  predictor.lstm_layers.{i}.x2g/p2g/g_norm/c_norm -> predictor.lstm.*
      (x2g/p2g have NO bias when lstm_layer_norm=True -> bi/bh zeroed;
       verified gate order i, f, g, o per torchaudio _CustomLSTM)
  predictor.linear + output_layer_norm         -> predictor.out_* / ln_*
  joiner.linear                                -> joiner.*
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x).astype(np.float32)


def convert_rnnt_state_dict(sd: Mapping[str, "object"],
                            num_layers: int = 20,
                            pred_layers: int = 3) -> Dict:
    sd = {k: _np(v) for k, v in sd.items()}

    def lin_w(name):
        return sd[name].T

    layers = []
    for i in range(num_layers):
        p = f"transcriber.transformer.emformer_layers.{i}."
        layers.append({
            "w_kv": lin_w(p + "attention.emb_to_key_value.weight"),
            "b_kv": sd[p + "attention.emb_to_key_value.bias"],
            "w_q": lin_w(p + "attention.emb_to_query.weight"),
            "b_q": sd[p + "attention.emb_to_query.bias"],
            "w_out": lin_w(p + "attention.out_proj.weight"),
            "b_out": sd[p + "attention.out_proj.bias"],
            "ln_in_scale": sd[p + "layer_norm_input.weight"],
            "ln_in_bias": sd[p + "layer_norm_input.bias"],
            "ff_ln_scale": sd[p + "pos_ff.0.weight"],
            "ff_ln_bias": sd[p + "pos_ff.0.bias"],
            "ff_w1": lin_w(p + "pos_ff.1.weight"),
            "ff_b1": sd[p + "pos_ff.1.bias"],
            "ff_w2": lin_w(p + "pos_ff.4.weight"),
            "ff_b2": sd[p + "pos_ff.4.bias"],
            "ln_out_scale": sd[p + "layer_norm_output.weight"],
            "ln_out_bias": sd[p + "layer_norm_output.bias"],
        })
    emformer = {k: np.stack([l[k] for l in layers]) for k in layers[0]}

    lstms = []
    for i in range(pred_layers):
        p = f"predictor.lstm_layers.{i}."
        wi = lin_w(p + "x2g.weight")
        wh = lin_w(p + "p2g.weight")
        H4 = wi.shape[1]
        lstms.append({
            "wi": wi,
            # x2g/p2g are bias-free under lstm_layer_norm (torchaudio
            # _CustomLSTM: bias only when layer_norm=False)
            "bi": sd.get(p + "x2g.bias", np.zeros(H4, np.float32)),
            "wh": wh,
            "bh": np.zeros(H4, np.float32),
            "g_scale": sd[p + "g_norm.weight"],
            "g_bias": sd[p + "g_norm.bias"],
            "c_scale": sd[p + "c_norm.weight"],
            "c_bias": sd[p + "c_norm.bias"],
        })
    lstm = {k: np.stack([l[k] for l in lstms]) for k in lstms[0]}

    return {
        "input_linear": {"w": lin_w("transcriber.input_linear.weight")},
        "emformer": emformer,
        "enc_out": {
            "w": lin_w("transcriber.output_linear.weight"),
            "b": sd["transcriber.output_linear.bias"],
            "ln_scale": sd["transcriber.layer_norm.weight"],
            "ln_bias": sd["transcriber.layer_norm.bias"],
        },
        "predictor": {
            "embedding": sd["predictor.embedding.weight"],
            "input_ln_scale": sd["predictor.input_layer_norm.weight"],
            "input_ln_bias": sd["predictor.input_layer_norm.bias"],
            "lstm": lstm,
            "out_w": lin_w("predictor.linear.weight"),
            "out_b": sd["predictor.linear.bias"],
            "ln_scale": sd["predictor.output_layer_norm.weight"],
            "ln_bias": sd["predictor.output_layer_norm.bias"],
        },
        "joiner": {
            "w": lin_w("joiner.linear.weight"),
            "b": sd["joiner.linear.bias"],
        },
    }


def convert_rnnt_checkpoint(ckpt_path: str, out_path: str,
                            num_layers: int = 20,
                            pred_layers: int = 3) -> dict:
    import torch
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    sd = {k: v for k, v in sd.items()}
    params = convert_rnnt_state_dict(sd, num_layers, pred_layers)
    save_params(out_path, params)
    return params


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint")
    parser.add_argument("output")
    parser.add_argument("--num-layers", type=int, default=20)
    parser.add_argument("--pred-layers", type=int, default=3)
    args = parser.parse_args()
    convert_rnnt_checkpoint(args.checkpoint, args.output,
                            args.num_layers, args.pred_layers)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
