"""A stream of questions about long documents (traffic kind ``doc_stream``).

A pool of ``pool`` live documents with Zipf(``zipf_s``) popularity over
their ranks.  Request i picks a rank, and asks the document there; after
``max_asks`` asks a document retires and a fresh one, with a new id and a
new length, takes its rank, so the hot set moves and no session grows
past ``len_max + max_asks`` positions.  Lengths are log-uniform on
[``len_min``, ``len_max``].  A request's prompt is its document with the
last token replaced by one drawn for the ask: a miss prefills it whole, a
hit decodes that last token on the session's cache.

Everything is a function of the seed and the request's index: the stream
is the same whatever the speed of the system that serves it.  The
documents' tokens come from a generator seeded by (seed, document id),
and each ask's last token from the seed.  The ranks asked and the
documents' lengths come from the mix's ``shape_seed``, so every run's seed
serves the same sizes in the same arrivals and only the tokens (and the
weights) differ: the window then measures the system, not the draw of the
work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np


@dataclass
class Ask:
    index: int
    session: str            # one session a document
    doc: int
    rank: int               # its popularity rank, 0 the most asked
    ask: int                # 0 .. max_asks - 1
    prompt: np.ndarray      # int64 [len]
    new_tokens: int


class DocStream:
    def __init__(self, params: Dict[str, Any], seed: int, vocab: int):
        self.p = dict(params)
        self.seed = int(seed)
        self.vocab = int(vocab)
        self.rng = np.random.default_rng([self.seed, 1])
        # ranks and lengths: the same for every run's seed
        self.shape_rng = np.random.default_rng([int(self.p["shape_seed"]), 5])
        pool, s = int(self.p["pool"]), float(self.p["zipf_s"])
        w = 1.0 / np.arange(1, pool + 1, dtype=np.float64) ** s
        self.shares = w / w.sum()
        self.cum = np.cumsum(self.shares)
        self.next_doc = 0
        self.docs: List[Dict[str, int]] = [self._fresh() for _ in range(pool)]
        self.index = 0

    def _fresh(self) -> Dict[str, int]:
        lo, hi = np.log(self.p["len_min"]), np.log(self.p["len_max"])
        n = int(round(float(np.exp(self.shape_rng.uniform(lo, hi)))))
        n = min(max(n, int(self.p["len_min"])), int(self.p["len_max"]))
        doc = {"id": self.next_doc, "len": n, "asks": 0}
        self.next_doc += 1
        return doc

    def tokens(self, doc_id: int, n: int) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 2, doc_id])
        return rng.integers(0, self.vocab, size=n, dtype=np.int64)

    def next(self) -> Ask:
        rank = int(np.searchsorted(self.cum, self.shape_rng.uniform(0.0, 1.0),
                                   side="right"))
        rank = min(rank, len(self.docs) - 1)
        doc = self.docs[rank]
        q = int(self.rng.integers(0, self.vocab))
        prompt = self.tokens(doc["id"], doc["len"])
        prompt[-1] = q
        ask = Ask(self.index, f"d{doc['id']}", doc["id"], rank, doc["asks"], prompt,
                  int(self.p["new_tokens"]))
        doc["asks"] += 1
        if doc["asks"] >= int(self.p["max_asks"]):
            self.docs[rank] = self._fresh()
        self.index += 1
        return ask


def make(params: Dict[str, Any], seed: int, vocab: int) -> DocStream:
    return DocStream(params, seed, vocab)
