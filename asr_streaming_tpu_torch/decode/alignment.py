"""CTC forced alignment: the trellis DP on the emission's device, then a
host backtrack.

Counterpart of asr_streaming_tpu/decode/alignment.py.  The O(T*N) forward
max-trellis is a ``lax.scan`` over frames there; here it is a loop over
the frames in torch, each step vectorised over the tokens, on the device
the emission lies on.  It is no Pallas kernel in the JAX package and has
no hand-written one here.  ``Segment``, ``backtrack``, ``merge_tokens``
and ``merge_words`` (numpy, host) are copied from that module.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Union

import numpy as np
import torch


@dataclasses.dataclass
class Segment:
    label: str
    start: float
    end: float
    score: float

    @property
    def length(self) -> float:
        return self.end - self.start


def ctc_trellis(emission: torch.Tensor, tokens: torch.Tensor,
                blank: int = 0) -> torch.Tensor:
    """Forward max-trellis [T+1, N+1] (reference get_trellis semantics).

    trellis[t+1, j+1] = max(trellis[t, j+1] + em[t, blank],     # stay
                            trellis[t, j]   + em[t, tokens[j]]) # advance

    Row 0 is [0, -inf, ...]; the all-blank column is +inf in the last N
    rows (reference alignment.py:44 ``trellis[-N:, 0] = inf``), which
    forces the path to consume every token during the backtrack."""
    T = emission.shape[0]
    N = tokens.shape[0]
    em_tok = emission[:, tokens.to(device=emission.device, dtype=torch.long)]
    em_blank = emission[:, blank]
    trellis = torch.empty((T + 1, N + 1), dtype=emission.dtype,
                          device=emission.device)
    trellis[0, 0] = 0.0
    trellis[0, 1:] = -float("inf")
    for t in range(T):
        prev = trellis[t]
        trellis[t + 1, 0] = prev[0] + em_blank[t]          # all-blank prefix
        trellis[t + 1, 1:] = torch.maximum(prev[1:] + em_blank[t],
                                           prev[:-1] + em_tok[t])
    trellis[max(T - N + 1, 0):, 0] = float("inf")
    return trellis


def backtrack(trellis: np.ndarray, emission: np.ndarray,
              tokens: Sequence[int], blank: int = 0) -> List[tuple]:
    """Host backtrack -> [(token_index, time_index, prob)] (reference
    backtrack, alignment.py:57-97)."""
    trellis = np.asarray(trellis)
    emission = np.asarray(emission)
    j = trellis.shape[1] - 1
    t_start = int(np.argmax(trellis[:, j]))

    path = []
    for t in range(t_start, 0, -1):
        stayed = trellis[t - 1, j] + emission[t - 1, blank]
        changed = trellis[t - 1, j - 1] + emission[t - 1, tokens[j - 1]]
        prob = float(np.exp(
            emission[t - 1, tokens[j - 1] if changed > stayed else blank]))
        path.append((j - 1, t - 1, prob))
        if changed > stayed:
            j -= 1
            if j == 0:
                break
    else:
        raise ValueError("Failed to align")
    return path[::-1]


def merge_tokens(path: List[tuple], tokens: Sequence[str],
                 feature_length: int, audio_length: float) -> List[Segment]:
    """Collapse path points into per-token segments (alignment.py:100-127)."""
    segments, i1 = [], 0
    while i1 < len(path):
        i2 = i1
        while i2 < len(path) and path[i1][0] == path[i2][0]:
            i2 += 1
        score = sum(p[2] for p in path[i1:i2]) / (i2 - i1)
        start = path[i1][1] / feature_length * audio_length
        end = (path[i2 - 1][1] + 1) / feature_length * audio_length
        segments.append(Segment(tokens[path[i1][0]], start, end, score))
        i1 = i2
    return segments


def merge_words(segments: List[Segment], silence: str = "|") -> List[Segment]:
    """Group token segments into words at silence boundaries
    (alignment.py:130-153)."""
    words, i1, i2 = [], 0, 0
    while i1 < len(segments):
        if i2 >= len(segments) or segments[i2].label == silence:
            if i1 != i2:
                segs = segments[i1:i2]
                word = "".join(s.label for s in segs)
                total = sum(s.length for s in segs)
                score = (sum(s.score * s.length for s in segs) / total
                         if total > 0 else 0.0)
                words.append(Segment(word, segs[0].start, segs[-1].end,
                                     score))
            i1 = i2 + 1
            i2 = i1
        else:
            i2 += 1
    return words


def force_align(emission: Union[np.ndarray, torch.Tensor],
                token_ids: Sequence[int], token_labels: Sequence[str],
                audio_seconds: float, blank: int = 0, silence: str = "|"):
    """Full pipeline (reference LightningASR.force_alignment,
    recognition.py:162-189): returns (token_segments, word_segments).
    The trellis runs where ``emission`` lies (a numpy array: the CPU)."""
    em = torch.as_tensor(emission)
    tokens = torch.as_tensor(np.asarray(token_ids, np.int64))
    trellis = ctc_trellis(em, tokens, blank).cpu().numpy()
    em_host = em.cpu().numpy()
    path = backtrack(trellis, em_host, list(token_ids), blank)
    token_segments = merge_tokens(path, list(token_labels),
                                  em_host.shape[0], audio_seconds)
    word_segments = merge_words(token_segments, silence)
    return token_segments, word_segments
