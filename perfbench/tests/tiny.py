"""Tiny cells for the CPU tests: the shipped cells' files with the model
shrunk to the port's ``ASRConfig.tiny`` / ``RNNTConfig.tiny`` widths and
the traffic to a handful of streams."""

from __future__ import annotations

import copy

from perfbench import harness

VI_TINY = {"n_mels": 128, "d_model": 64, "ctc_hidden_dim": 48, "vocab_size": 21,
           "emformer": {"d_model": 64, "num_heads": 4, "ffn_dim": 96,
                        "num_layers": 2},
}
EN_TINY = {"n_mels": 16, "input_linear_dim": 16, "d_model": 64,
           "encoding_dim": 48, "vocab_size": 32, "blank": 31,
           "pred_embed_dim": 32, "pred_hidden": 32, "pred_layers": 1,
           "emformer": {"d_model": 64, "num_heads": 4, "ffn_dim": 96,
                        "num_layers": 2, "left_context_length": 8},
           "mel": {"n_mels": 16},
           "weights": {"blank_share": 0.4}}


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) else v
    return out


def tiny_model(name: str) -> dict:
    cell = {"vi-ctc-emformer20": VI_TINY, "en-rnnt-emformer-base": EN_TINY}
    model = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    model = _merge(model, cell[name])
    model["serving"]["compute_dtype"] = "float32"
    return model


def tiny_cell(name: str, streams: int = 6, groups: int = 2,
              warm_s: float = 1.0) -> harness.Cell:
    cell = harness.load_cell(name)
    model = tiny_model(cell.entry["config"])
    mix = dict(cell.mix, streams=streams, pool_s=30.0, warm_s=warm_s)
    work = copy.deepcopy(cell.work)
    work["serving"] = {"max_active_connections": -(-streams // groups) * groups,
                       "scheduler_groups": groups}
    work["trace"] = {"offset_s": 0.5, "seconds": 0.5}
    work["check"]["sample_streams"] = 3
    return harness.Cell(name, cell.entry, work, model, mix)

