"""Model API of the port: init / input specs / caches / loss / train,
prefill and decode steps.

A port of the reference's ``models/api.py``, dispatching on the
architecture family (decoder-only LM, with or without the vision stub, vs
encoder-decoder).  Params are drawn on the target device from an explicit
``torch.Generator``.  The train step is a plain function (there is no
``jit``) that returns new param and optimizer trees and changes none of its
arguments.

The dry run's inputs: ``param_specs`` and ``input_specs`` give a tree of
``Spec`` (shape and dtype, the reference's ``jax.ShapeDtypeStruct``) for
the full-size model and for every input of an (arch x shape) cell, built
by the real init and cache code under ``FakeTensorMode``, so nothing is
allocated (qwen3-moe-235b-a22b's 235 B params included); ``synth_inputs``
makes concrete inputs of those specs and ``make_step`` the step function a
cell runs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..optim.adamw import (
    AdamWConfig,
    adamw8bit_init,
    adamw8bit_update,
    adamw_init,
    adamw_update,
    cosine_schedule,
)
from ..obs.spans import span
from ..tree import tree_flatten_with_paths, tree_leaves, tree_map, tree_unflatten
from . import encdec, lm
from .sharding import ShardCtx, distribute_tree, laid_like

OPT8BIT_PARAM_THRESHOLD = 100e9  # >100B params: 8-bit AdamW moments


def use_8bit_opt(cfg: ArchConfig) -> bool:
    return cfg.param_count() > OPT8BIT_PARAM_THRESHOLD


def is_encdec(cfg: ArchConfig) -> bool:
    return cfg.encoder_layers > 0


def attn_chunk(seq_len: int) -> int:
    if seq_len >= 1 << 15:
        return 512
    return min(1024, max(128, seq_len))


def init_params(cfg: ArchConfig, gen: Optional[torch.Generator] = None, *,
                device="cuda", seed: int = 0):
    """Random params from ``gen`` (default: a generator on ``device`` seeded
    with ``seed``); they live on the generator's device."""
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
    if is_encdec(cfg):
        return encdec.encdec_init(gen, cfg)
    return lm.lm_init(gen, cfg)


def cache_init(cfg: ArchConfig, batch: int, cap: int, device="cuda", *,
               ctx: ShardCtx = ShardCtx()):
    """Decode caches of capacity ``cap``; an encoder-decoder's cross caches
    hold ``cap`` encoder positions too, as the reference's do.  Under a
    mesh each leaf is a DTensor placed by ``cache_leaf_spec`` (K/V: batch
    on 'dp', capacity on 'tp')."""
    if is_encdec(cfg):
        caches = encdec.encdec_cache_init(cfg, batch, cap, cap, device)
    else:
        caches = lm.lm_cache_init(cfg, batch, cap, device)
    if ctx.mesh is None:
        return caches
    from ..launch.shardings import cache_specs

    return distribute_tree(ctx, caches, cache_specs(ctx, caches))


# ------------------------------------------------------------ dry-run inputs
@dataclass(frozen=True)
class Spec:
    """Shape and dtype of a tensor that is not allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def _specs_of(build):
    """``build()`` run under ``FakeTensorMode`` (its tensors carry shapes
    and dtypes, no storage), as a tree of ``Spec``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        tree = build()
    return tree_map(lambda t: Spec(tuple(t.shape), t.dtype), tree)


def param_specs(cfg: ArchConfig):
    """Tree of ``Spec`` for the full-size model's params, allocating
    nothing."""
    return _specs_of(lambda: init_params(cfg, torch.Generator("cpu")))


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``Spec`` stand-ins for every input of this (arch, shape) cell.

    train:   {tokens} (+audio_embeds / patch_embeds for stub frontends)
    prefill: same as train inputs
    decode:  {token, pos, caches}: one new token against a seq_len cache.
    """
    B, S = shape.global_batch, shape.seq_len
    i32, bf16 = torch.int32, torch.bfloat16
    decode = shape.kind not in ("train", "prefill")
    if is_encdec(cfg):
        if not decode:
            return {"audio_embeds": Spec((B, S, cfg.d_model), bf16),
                    "tokens": Spec((B, encdec.text_len(S)), i32)}
    elif not decode:
        if cfg.frontend == "vision":
            P = min(cfg.num_patches, S // 2)
            return {"patch_embeds": Spec((B, P, cfg.d_model), bf16),
                    "tokens": Spec((B, S - P), i32)}
        return {"tokens": Spec((B, S), i32)}
    return {"token": Spec((B,), i32), "pos": Spec((), i32),
            "caches": _specs_of(lambda: cache_init(cfg, B, S, device="cpu"))}


def synth_inputs(cfg: ArchConfig, shape: ShapeConfig,
                 gen: Optional[torch.Generator] = None, *,
                 device="cuda") -> Dict[str, Any]:
    """Concrete inputs of ``input_specs``' shapes and dtypes (smoke tests):
    token ids drawn from ``gen`` (default: one on ``device`` seeded with 1,
    as the reference defaults to ``PRNGKey(1)``), ``pos`` min(seq_len - 1,
    7), every float input and cache zero (valid: decode masks a cache by
    position)."""
    if gen is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
    specs = input_specs(cfg, shape)
    paths, leaves, unflatten = tree_flatten_with_paths(specs)

    def make(path, s):
        if s.dtype != torch.int32:
            return torch.zeros(s.shape, dtype=s.dtype, device=gen.device)
        if path == "pos":
            return torch.tensor(min(shape.seq_len - 1, 7), dtype=torch.int32,
                                device=gen.device)
        return torch.randint(0, cfg.vocab_size, s.shape, generator=gen,
                             dtype=torch.int32, device=gen.device)

    return unflatten([make(p, s) for p, s in zip(paths, leaves)])


def make_prefill_step(cfg: ArchConfig, shape: ShapeConfig, *,
                      ctx: ShardCtx = ShardCtx()):
    fn = encdec.encdec_prefill if is_encdec(cfg) else lm.lm_prefill
    return functools.partial(fn, cfg=cfg, ctx=ctx, chunk=attn_chunk(shape.seq_len))


def make_decode_step(cfg: ArchConfig, *, ctx: ShardCtx = ShardCtx()):
    fn = encdec.encdec_decode if is_encdec(cfg) else lm.lm_decode
    return functools.partial(fn, cfg=cfg, ctx=ctx)


def make_step(cfg: ArchConfig, shape: ShapeConfig, *, ctx: ShardCtx = ShardCtx()):
    """The step function a dry-run cell runs, by shape kind."""
    if shape.kind == "train":
        return make_train_step(cfg, shape, ctx=ctx)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, ctx=ctx)
    return make_decode_step(cfg, ctx=ctx)


def make_loss_fn(cfg: ArchConfig, shape: ShapeConfig, *, ctx: ShardCtx = ShardCtx()):
    fn = encdec.encdec_loss if is_encdec(cfg) else lm.lm_loss
    return functools.partial(fn, cfg=cfg, ctx=ctx, chunk=attn_chunk(shape.seq_len))


def make_train_step(cfg: ArchConfig, shape: ShapeConfig,
                    opt: AdamWConfig = AdamWConfig(), total_steps: int = 10_000,
                    microbatches: Optional[int] = None, *,
                    ctx: ShardCtx = ShardCtx()):
    """(params, opt_state, batch) -> (params, opt_state, metrics).

    ``microbatches`` > 1 accumulates grads: the batch is split along dim 0,
    each slice runs forward and backward in turn, and its grads are added
    into an f32 accumulator, each divided by the slice count.  Each slice's
    forward and backward runs in the span ``train.grad``, the update in
    ``train.optimizer``.  Returns new trees; the caller's params, optimizer
    state and batch stay as they were.
    Under a mesh (``ctx``) the params, optimizer state and batch are
    DTensors, and so are the grads, the new trees and the metrics.
    """
    loss_fn = make_loss_fn(cfg, shape, ctx=ctx)
    n_mb = microbatches if microbatches is not None else cfg.train_microbatches(
        shape.global_batch)

    def grad_of(params, mb):
        with span("train.grad"):
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            # backward recomputes checkpointed chunks: it runs in the scope too
            with torch.enable_grad(), ctx.scope():
                loss, extras = loss_fn(tree_unflatten(params, leaves), mb)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            # each grad in its param's layout (partial sums reduced), so the
            # update keeps every param and moment where the mesh placed it
            grads = [torch.zeros_like(p) if g is None else laid_like(g, p)
                     for p, g in zip(leaves, grads)]
            extras = {k: v.detach() for k, v in extras.items()}
            return (loss.detach(), extras), tree_unflatten(params, grads)

    def train_step(params, opt_state, batch):
        eightbit = use_8bit_opt(cfg)
        if n_mb == 1:
            (loss, extras), grads = grad_of(params, batch)
        else:
            size = tree_leaves(batch)[0].shape[0] // n_mb
            mbs = [tree_map(lambda x: x[i * size:(i + 1) * size], batch)
                   for i in range(n_mb)]
            # zeros_like keeps a DTensor param's placements
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            dev = tree_leaves(params)[0].device
            loss_m = ctx.replicate(torch.zeros((), dtype=torch.float32, device=dev))
            aux_m = ctx.replicate(torch.zeros((), dtype=torch.float32, device=dev))
            for mb in mbs:
                (_, ex), g = grad_of(params, mb)
                grads = tree_map(lambda a, gg: a + gg.to(torch.float32) / n_mb,
                                 grads, g)
                loss_m = loss_m + ex["loss"] / n_mb
                aux_m = aux_m + ex.get("aux", 0.0) / n_mb
            loss, extras = loss_m, {"loss": loss_m, "aux": aux_m}
        # the schedule runs on the post-increment step (lr > 0 from step one)
        lr_scale = cosine_schedule(
            opt_state["step"] + 1, warmup=min(100, max(1, total_steps // 10)),
            total=total_steps)
        update = adamw8bit_update if eightbit else adamw_update
        with span("train.optimizer"), ctx.scope():
            params, opt_state, om = update(grads, opt_state, params, opt, lr_scale)
        metrics = {"loss": extras["loss"], "total_loss": loss, **om}
        return params, opt_state, metrics

    return train_step


def init_opt_state(params, cfg: Optional[ArchConfig] = None):
    if cfg is not None and use_8bit_opt(cfg):
        return adamw8bit_init(params)
    return adamw_init(params)
