"""Random weights in the port's parameter layout, made on the device.

One ``torch.Generator`` on the run's device, seeded from ``--seed``, fills
each stacked leaf in one call, with the distributions of the port's own
initialisers (``models/emformer.py::init_emformer_params``,
``models/encoder.py``, ``models/rnnt.py``): Linear weights uniform in
+-sqrt(3 / fan_in), biases +-1 / sqrt(fan_in), the Emformer's q and kv
weights Xavier-uniform with the depthwise gain 1 / sqrt(layer + 1), layer
norms at one and zero, the predictor's embedding N(0, 1 / 512).  The
joiner's weights are scaled by the configuration's ``joiner_gain``, so
that its logits are sharp enough for the beam to emit; ``calibrate.py``
then sets the blank's output column and bias.
Weights stay float32, as the port's tree holds them (its kernels keep
their own bf16 copies).  The frontend's DFT and mel matrices are the
port's own constants, made by the port.
"""

from __future__ import annotations

import math

import torch


class _Maker:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def uniform(self, shape, bound):
        """U(-bound, bound); ``bound`` a number or a tensor that
        broadcasts against ``shape``."""
        u = torch.rand(shape, generator=self.gen, device=self.device)
        return (u * 2.0 - 1.0) * bound

    def linear(self, shape, fan_in):
        return self.uniform(shape, math.sqrt(3.0 / fan_in))

    def bias(self, shape, fan_in):
        return self.uniform(shape, 1.0 / math.sqrt(fan_in))

    def ones(self, shape):
        return torch.ones(shape, device=self.device)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device)


def _emformer(mk: _Maker, em: dict) -> dict:
    L, D, Fd = em["num_layers"], em["d_model"], em["ffn_dim"]
    gain = torch.tensor([1.0 / math.sqrt(i + 1) for i in range(L)],
                        device=mk.device)[:, None, None]
    xav = lambda a, b: gain * math.sqrt(6.0 / (a + b))
    return {
        "w_q": mk.uniform((L, D, D), xav(D, D)),
        "b_q": mk.bias((L, D), D),
        "w_kv": mk.uniform((L, D, 2 * D), xav(D, 2 * D)),
        "b_kv": mk.bias((L, 2 * D), D),
        "w_out": mk.linear((L, D, D), D), "b_out": mk.bias((L, D), D),
        "ln_in_scale": mk.ones((L, D)), "ln_in_bias": mk.zeros((L, D)),
        "ff_ln_scale": mk.ones((L, D)), "ff_ln_bias": mk.zeros((L, D)),
        "ff_w1": mk.linear((L, D, Fd), D), "ff_b1": mk.bias((L, Fd), D),
        "ff_w2": mk.linear((L, Fd, D), Fd), "ff_b2": mk.bias((L, D), Fd),
        "ln_out_scale": mk.ones((L, D)), "ln_out_bias": mk.zeros((L, D)),
    }


def ctc_weights(seed: int, model: dict, device) -> dict:
    """The Vietnamese CTC model's ``encoder`` tree."""
    mk = _Maker(seed, device)
    D, V, Hc = model["d_model"], model["vocab_size"], model["ctc_hidden_dim"]
    n_in = model["n_mels"]
    ctc = {"w1": mk.linear((D, Hc), D), "b1": mk.bias((Hc,), D),
           "w2": mk.linear((Hc, V), Hc), "b2": mk.bias((V,), Hc)}
    return {"input_linear": {"w": mk.linear((n_in, D // 4), n_in)},
            "emformer": _emformer(mk, model["emformer"]),
            "ctc": ctc}


def rnnt_weights(seed: int, model: dict, device) -> dict:
    """The English Emformer-RNNT's tree (without the frontend)."""
    mk = _Maker(seed, device)
    D, E, V = model["d_model"], model["encoding_dim"], model["vocab_size"]
    H, Pe, nl = model["pred_hidden"], model["pred_embed_dim"], model["pred_layers"]
    n_in, lin = model["n_mels"], model["input_linear_dim"]
    lstm = {"wi": mk.linear((nl, Pe, 4 * H), Pe),
            "bi": mk.bias((nl, 4 * H), Pe),
            "wh": mk.linear((nl, H, 4 * H), H),
            "bh": mk.bias((nl, 4 * H), H),
            "g_scale": mk.ones((nl, 4 * H)), "g_bias": mk.zeros((nl, 4 * H)),
            "c_scale": mk.ones((nl, H)), "c_bias": mk.zeros((nl, H))}
    if nl > 1 and Pe != H:
        raise ValueError("stacked LSTM leaves need pred_embed_dim == "
                         "pred_hidden")
    w = model["weights"]
    joiner = {"w": mk.linear((E, V), E) * w["joiner_gain"],
              "b": mk.bias((V,), E)}
    emb = torch.randn((V, Pe), generator=mk.gen, device=mk.device) * Pe ** -0.5
    return {
        "input_linear": {"w": mk.linear((n_in, lin), n_in)},
        "emformer": _emformer(mk, model["emformer"]),
        "enc_out": {"w": mk.linear((D, E), D), "b": mk.bias((E,), D),
                    "ln_scale": mk.ones((E,)), "ln_bias": mk.zeros((E,))},
        "predictor": {"embedding": emb,
                      "input_ln_scale": mk.ones((Pe,)),
                      "input_ln_bias": mk.zeros((Pe,)),
                      "lstm": lstm,
                      "out_w": mk.linear((H, E), H), "out_b": mk.bias((E,), H),
                      "ln_scale": mk.ones((E,)), "ln_bias": mk.zeros((E,))},
        "joiner": joiner,
    }

