"""Request arrival processes and request objects for the serving simulator.

The paper simulates users with the `requests` library at fixed 1-second
intervals over the alpaca dataset.  We model arrivals as a deterministic
uniform process (paper default) or Poisson, and requests carry a prompt
length + target output length drawn from an alpaca-like distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    rid: int
    arrival_s: float
    prompt_len: int
    max_new_tokens: int


@dataclasses.dataclass
class ArrivalProcess:
    """Generates request arrival times + shapes.

    kind: 'uniform' (paper default: one request every `interval_s` seconds)
          or 'poisson' (rate 1/interval_s).
    Prompt/output lengths follow a clipped lognormal fit of alpaca prompts
    (median ~48 tokens) and the paper's 70-token generation cap.
    """

    interval_s: float = 1.0
    kind: str = "uniform"
    prompt_median: int = 48
    prompt_sigma: float = 0.6
    prompt_max: int = 512
    max_new_tokens: int = 70
    seed: int = 0

    def generate(self, n_requests: int) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        t = 0.0
        for rid in range(n_requests):
            if self.kind == "uniform":
                arrival = rid * self.interval_s
            elif self.kind == "poisson":
                t += rng.exponential(self.interval_s)
                arrival = t
            else:
                raise ValueError(f"unknown arrival kind {self.kind!r}")
            plen = int(np.clip(
                np.round(np.exp(np.log(self.prompt_median)
                                + self.prompt_sigma * rng.standard_normal())),
                4, self.prompt_max))
            yield Request(rid=rid, arrival_s=float(arrival), prompt_len=plen,
                          max_new_tokens=self.max_new_tokens)

    @property
    def rate(self) -> float:
        return 1.0 / self.interval_s
