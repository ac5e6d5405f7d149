"""Input and state sharding assignment for the step functions.

A port of the reference's ``launch/shardings.py``.  Params: FSDP('dp') x
tensor('tp') via the ``models.sharding`` rules.  Optimizer moments: the
spec of their parameter; the step counter replicated.  Batches: tokens and
batched inputs on 'dp'.  Decode caches: the KV seq dim on 'tp', batch on
'dp'; recurrent states batch on 'dp', width on 'tp'.  Every assignment
passes the divisibility guard (``ShardCtx``), so a global batch of 1
replicates.  ``step_out_shardings`` and ``with_shardings`` are placement
helpers: the first gives each output its ``NamedSharding``, the second
distributes a tree of tensors by a spec tree.
"""

from __future__ import annotations

from typing import Any, Dict

from ..configs.base import ArchConfig, ShapeConfig
from ..models.sharding import (
    P,
    ShardCtx,
    distribute_tree,
    map_specs,
    tree_param_specs,
)
from ..tree import tree_flatten_with_paths, tree_leaves


def cache_leaf_spec(ctx: ShardCtx, path: str, shape) -> P:
    """Sharding rule for one decode-cache leaf by its key name."""
    rank = len(shape)
    name = path.rsplit("/", 1)[-1]
    logical = [None] * rank
    if name in ("k", "v", "ck", "cv"):          # [..., B, cap, Hkv, Dh]
        logical[-4] = "dp"
        logical[-3] = "tp"
    elif name == "S":                            # [..., B, H, K, V]
        logical[-4] = "dp"
    elif name in ("shift_tm", "shift_cm"):       # [..., B, D]
        logical[-2] = "dp"
        logical[-1] = "tp"
    elif name == "h":                            # [..., B, W]
        logical[-2] = "dp"
        logical[-1] = "tp"
    elif name == "conv":                         # [..., B, cw-1, W]
        logical[-3] = "dp"
        logical[-1] = "tp"
    return ctx.spec(logical, shape)


def _map_with_paths(fn, tree):
    paths, leaves, unflatten = tree_flatten_with_paths(tree)
    return unflatten([fn(p, tuple(l.shape)) for p, l in zip(paths, leaves)])


def cache_specs(ctx: ShardCtx, caches):
    """P tree for a decode-cache tree, one ``cache_leaf_spec`` a leaf."""
    return _map_with_paths(lambda p, s: cache_leaf_spec(ctx, p, s), caches)


def batch_specs(ctx: ShardCtx, cfg: ArchConfig, shape: ShapeConfig,
                specs: Dict[str, Any]):
    """P tree for a batch (leaves: anything with a shape)."""

    def one(pstr, s):
        if "caches" in pstr:
            return cache_leaf_spec(ctx, pstr, s)
        name = pstr.rsplit("/", 1)[-1]
        if name == "tokens":
            return ctx.spec(["dp", None], s)
        if name == "token":
            return ctx.spec(["dp"], s)
        if name == "pos":
            return P()
        if name in ("audio_embeds", "patch_embeds"):
            return ctx.spec(["dp", None, None], s)
        return P(*([None] * len(s)))

    return _map_with_paths(one, specs)


def opt_state_specs(ctx: ShardCtx, params_shapes, opt_shapes):
    """Opt-state specs mirroring the parameter rules.

    Works for both plain AdamW ({m, v, step}) and 8-bit AdamW
    ({m, v, ms, vs, step}): each subtree has the same paths as params, so
    the same path rules apply; scale tensors (last dim 1) are left unsharded
    on that dim by the divisibility guard."""
    out = {}
    for k, sub in opt_shapes.items():
        out[k] = P() if k == "step" else tree_param_specs(ctx, sub)
    return out


def step_out_specs(ctx: ShardCtx, kind: str, out_shapes):
    """P tree for a step function's outputs.

    train: (params, opt_state, metrics) -> (param rules, opt rules, replicated)
    prefill/decode: (logits, caches) -> (['dp','tp'], cache rules)
    """
    if kind == "train":
        params_s, opt_s, metrics_s = out_shapes
        ps = tree_param_specs(ctx, params_s)
        os_ = opt_state_specs(ctx, params_s, opt_s)
        _, leaves, unflatten = tree_flatten_with_paths(metrics_s)
        ms = unflatten([P() for _ in leaves])
        return (ps, os_, ms)
    logits_s, caches_s = out_shapes
    return (
        ctx.spec(["dp", "tp"], logits_s.shape),
        cache_specs(ctx, caches_s),
    )


def step_out_shardings(ctx: ShardCtx, kind: str, out_shapes):
    """``NamedSharding`` tree (None leaves without a mesh) for a step's
    outputs."""
    return map_specs(ctx.named, step_out_specs(ctx, kind, out_shapes))


def with_shardings(ctx: ShardCtx, tree, specs):
    """``tree`` (the same whole tensors on every rank) distributed by the P
    tree ``specs``; unchanged without a mesh."""
    if not tree_leaves(tree):
        return tree
    return distribute_tree(ctx, tree, specs)
