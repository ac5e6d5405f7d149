"""Plain PyTorch oracles for the dispatch window-scoring kernels.

Ports of ``dispatch_scores_ref`` and ``dispatch_score_update_ref`` in the
reference's ``kernels/dispatch_score/ref.py``.
"""

from __future__ import annotations

import torch


def dispatch_scores_ref(demand, presence):
    """Window scores S = demand @ presence.T in float32.

    demand:   [W, O]  per queued-item object bitmap (multiplicity-weighted)
    presence: [E, O]  per executor cached-object (tier-weighted) matrix
    returns   [W, E]  weighted cache-overlap score per (item, executor)
    """
    return demand.to(torch.float32) @ presence.to(torch.float32).T


def dispatch_score_update_ref(scores, mult, delta):
    """Incremental rank-K score update S' = S + mult @ delta in float32.

    scores: [W, E]; mult: [W, K]; delta: [K, E]; returns [W, E].
    """
    return scores.to(torch.float32) + (
        mult.to(torch.float32) @ delta.to(torch.float32))
