"""Online endpointing: Kaldi-style rule engine + n-gram LM relative cost.

Copied from asr_streaming_tpu/streaming/endpoint.py.

Re-implementation of the reference's rule engine (reference:
streaming_decoder/online_endpoint.py:4-94) and ARPA-based LM endpointing
cost (reference: streaming_decoder/utils.py:109-139).  A rule fires when

  (contains_nonsilence or not must_contain_nonsilence)
  and trailing_silence >= min_trailing_silence
  and relative_cost    <  max_relative_cost
  and utterance_length >= min_utterance_length

where relative_cost = -5 * logP(utterance-final continuation -> </s>)
under a backed-off n-gram lookup.
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class EndpointRule:
    must_contain_nonsilence: bool
    min_trailing_silence: float
    min_utterance_length: float
    max_relative_cost: float


def load_endpoint_rules(rules_cfg: Dict[str, dict]) -> Dict[str, EndpointRule]:
    """Build rules from a {name: {field: value}} mapping (the shape of the
    reference's Endpointing_rules YAML blocks, asr-online.yaml:31-110)."""
    out = {}
    for name, args in rules_cfg.items():
        out[name] = EndpointRule(
            must_contain_nonsilence=bool(args["must_contain_nonsilence"]),
            min_trailing_silence=float(args["min_trailing_silence"]),
            min_utterance_length=float(args["min_utterance_length"]),
            max_relative_cost=float(args["max_relative_cost"]),
        )
    return out


def rule_activated(rule: EndpointRule, trailing_silence: float,
                   utterance_length: float, relative_cost: float) -> bool:
    contains_nonsilence = utterance_length > trailing_silence
    return ((contains_nonsilence or not rule.must_contain_nonsilence)
            and trailing_silence >= rule.min_trailing_silence
            and relative_cost < rule.max_relative_cost
            and utterance_length >= rule.min_utterance_length)


def detect_endpointing(rules: Dict[str, EndpointRule],
                       utterance_length: float, trailing_silence: float,
                       relative_cost: float,
                       ) -> Tuple[bool, Optional[str]]:
    """First-match-wins over the rule table."""
    for name, rule in rules.items():
        if rule_activated(rule, trailing_silence, utterance_length,
                          relative_cost):
            return True, name
    return False, None


# Production rule tables from the reference configs (asr-online.yaml:31-110,
# asr-online-en.yaml:31-55).
VI_DEFAULT_RULES = load_endpoint_rules({
    "rule1.1": dict(must_contain_nonsilence=True, min_trailing_silence=1.0,
                    min_utterance_length=0.0, max_relative_cost=math.inf),
    "rule1.2": dict(must_contain_nonsilence=True, min_trailing_silence=0.9,
                    min_utterance_length=0.0, max_relative_cost=8),
    "rule1.3": dict(must_contain_nonsilence=True, min_trailing_silence=0.8,
                    min_utterance_length=0.0, max_relative_cost=5),
    "rule1.4": dict(must_contain_nonsilence=True, min_trailing_silence=0.7,
                    min_utterance_length=0.0, max_relative_cost=2),
    "rule2.1": dict(must_contain_nonsilence=True, min_trailing_silence=1.0,
                    min_utterance_length=10.0, max_relative_cost=math.inf),
    "rule2.2": dict(must_contain_nonsilence=True, min_trailing_silence=0.9,
                    min_utterance_length=10.0, max_relative_cost=8),
    "rule2.3": dict(must_contain_nonsilence=True, min_trailing_silence=0.7,
                    min_utterance_length=10.0, max_relative_cost=5),
    "rule2.4": dict(must_contain_nonsilence=True, min_trailing_silence=0.6,
                    min_utterance_length=10.0, max_relative_cost=2),
    "rule3.1": dict(must_contain_nonsilence=True, min_trailing_silence=0.9,
                    min_utterance_length=20.0, max_relative_cost=math.inf),
    "rule3.2": dict(must_contain_nonsilence=True, min_trailing_silence=0.8,
                    min_utterance_length=20.0, max_relative_cost=8),
    "rule3.3": dict(must_contain_nonsilence=True, min_trailing_silence=0.7,
                    min_utterance_length=20.0, max_relative_cost=5),
    "rule3.4": dict(must_contain_nonsilence=True, min_trailing_silence=0.6,
                    min_utterance_length=20.0, max_relative_cost=2),
    "rule4": dict(must_contain_nonsilence=True, min_trailing_silence=0.0,
                  min_utterance_length=40.0, max_relative_cost=math.inf),
})

EN_DEFAULT_RULES = load_endpoint_rules({
    "rule1.1": dict(must_contain_nonsilence=True, min_trailing_silence=1.0,
                    min_utterance_length=0.0, max_relative_cost=math.inf),
    "rule2.1": dict(must_contain_nonsilence=True, min_trailing_silence=0.8,
                    min_utterance_length=5.0, max_relative_cost=8),
    "rule3.1": dict(must_contain_nonsilence=True, min_trailing_silence=0.7,
                    min_utterance_length=15.0, max_relative_cost=5),
    "rule4": dict(must_contain_nonsilence=True, min_trailing_silence=0.0,
                  min_utterance_length=30.0, max_relative_cost=math.inf),
})


class NgramEndpointCost:
    """ARPA-file-backed end-of-sentence relative cost
    (reference utils.py:109-139).

    With no LM loaded (or no matching suffix), returns NO_LM_COST — a large
    finite value so cost-gated rules never fire but unconditional rules
    (max_relative_cost = inf) still do.
    """

    NO_LM_COST = 1e9

    def __init__(self, order: int = 4,
                 logprobs: Optional[Dict[str, float]] = None):
        self.order = order
        self.logprobs = logprobs or {}

    @classmethod
    def from_arpa(cls, path: str) -> "NgramEndpointCost":
        order, logprobs = 4, {}
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                line = line.rstrip("\n")
                parts = line.split("\t")
                if len(parts) >= 2:
                    try:
                        logprobs[parts[1]] = float(parts[0])
                    except ValueError:
                        pass
                else:
                    m = re.match(r"ngram (\d+)=", line)
                    if m:
                        order = int(m.group(1))
        return cls(order, logprobs)

    def relative_cost(self, utterance: str) -> float:
        """-5 * logP of the longest-matching utterance-final n-gram ending
        in </s> (backing off by dropping the leftmost word)."""
        if not self.logprobs:
            return self.NO_LM_COST
        context = ("<s> " + utterance).split()[1 - self.order:]
        context.append("</s>")
        while context:
            hit = self.logprobs.get(" ".join(context))
            if hit is not None:
                return -5.0 * hit
            context.pop(0)
        return self.NO_LM_COST
