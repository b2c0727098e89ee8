"""Convert a speechbrain ECAPA-TDNN checkpoint to framework npz.

Copied from asr_streaming_tpu/tools/convert_ecapa.py; it writes the
``.npz`` both packages read.

Migration path for the reference's speaker-verification model: it loads
speechbrain's ``spkrec-ecapa-voxceleb`` ``EncoderClassifier`` (reference:
streaming_decoder/streaming_server.py:192-196) whose embedding model is
``speechbrain.lobes.models.ECAPA_TDNN.ECAPA_TDNN``.  This tool maps that
``embedding_model.ckpt`` state dict onto our parameter tree
(models/ecapa.py) and writes the npz the server's ``speaker_weights:``
config key loads.

  python -m asr_streaming_tpu_torch.tools.convert_ecapa \
      embedding_model.ckpt out_params.npz

speechbrain module -> framework mapping (conv weights stay [out,in,k];
the final fc is a k=1 conv -> Linear transpose; BatchNorm running stats
reshape to [C,1]):

  blocks.0.{conv.conv,norm.norm}               -> in_conv / in_bn
  blocks.{1..3}.tdnn1                          -> blocks[i].conv1/bn1
  blocks.{1..3}.res2net_block.blocks.{j}       -> blocks[i].res2[j]/res2_bn[j]
  blocks.{1..3}.tdnn2                          -> blocks[i].conv3/bn3
  blocks.{1..3}.se_block.conv{1,2}             -> blocks[i].se_down/se_up
  mfa.{conv.conv,norm.norm}                    -> mfa / mfa_bn
  asp.tdnn.{conv.conv,norm.norm}               -> att_conv1 / att_bn
  asp.conv.conv                                -> att_conv2
  asp_bn.norm                                  -> out_bn
  fc.conv                                      -> out_w / out_b
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from asr_streaming_tpu_torch.models.ecapa import EcapaConfig


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu().numpy() if hasattr(x, "detach")
                      else x).astype(np.float32)


def _conv(sd, prefix):
    return {"w": sd[prefix + ".weight"], "b": sd[prefix + ".bias"]}


def _bn(sd, prefix):
    return {"scale": sd[prefix + ".weight"][:, None],
            "bias": sd[prefix + ".bias"][:, None],
            "mean": sd[prefix + ".running_mean"][:, None],
            "var": sd[prefix + ".running_var"][:, None]}


def convert_ecapa_state_dict(sd: Mapping[str, "object"],
                             cfg: EcapaConfig = EcapaConfig()) -> Dict:
    sd = {k: _np(v) for k, v in sd.items()}
    params = {
        "in_conv": _conv(sd, "blocks.0.conv.conv"),
        "in_bn": _bn(sd, "blocks.0.norm.norm"),
        "blocks": [],
    }
    for i in range(1, 1 + len(cfg.dilations)):
        p = f"blocks.{i}."
        block = {
            "conv1": _conv(sd, p + "tdnn1.conv.conv"),
            "bn1": _bn(sd, p + "tdnn1.norm.norm"),
            "res2": [
                _conv(sd, p + f"res2net_block.blocks.{j}.conv.conv")
                for j in range(cfg.res2net_scale - 1)],
            "res2_bn": [
                _bn(sd, p + f"res2net_block.blocks.{j}.norm.norm")
                for j in range(cfg.res2net_scale - 1)],
            "conv3": _conv(sd, p + "tdnn2.conv.conv"),
            "bn3": _bn(sd, p + "tdnn2.norm.norm"),
            "se_down": _conv(sd, p + "se_block.conv1.conv"),
            "se_up": _conv(sd, p + "se_block.conv2.conv"),
        }
        params["blocks"].append(block)
    params["mfa"] = _conv(sd, "mfa.conv.conv")
    params["mfa_bn"] = _bn(sd, "mfa.norm.norm")
    params["att_conv1"] = _conv(sd, "asp.tdnn.conv.conv")
    params["att_bn"] = _bn(sd, "asp.tdnn.norm.norm")
    params["att_conv2"] = _conv(sd, "asp.conv.conv")
    params["out_bn"] = _bn(sd, "asp_bn.norm")
    params["out_w"] = sd["fc.conv.weight"][:, :, 0].T
    params["out_b"] = (sd["fc.conv.bias"]
                       if "fc.conv.bias" in sd
                       else np.zeros(cfg.embedding_dim, np.float32))
    return params


def convert_ecapa_checkpoint(ckpt_path: str, out_path: str,
                             cfg: EcapaConfig = EcapaConfig()) -> dict:
    import torch
    from asr_streaming_tpu_torch.utils.checkpoint import save_params

    blob = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    # speechbrain saves the embedding model's state dict flat; strip an
    # optional "embedding_model." prefix from full-system dicts
    sd = {k.removeprefix("embedding_model."): v for k, v in sd.items()}
    params = convert_ecapa_state_dict(sd, cfg)
    save_params(out_path, params)
    return params


def main():
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("checkpoint",
                        help="speechbrain embedding_model.ckpt")
    parser.add_argument("output")
    args = parser.parse_args()
    convert_ecapa_checkpoint(args.checkpoint, args.output)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
