"""Decoder-only LM on torch over heterogeneous layer patterns: 'A' (full)
and 'L' (windowed) attention with dense or MoE FFNs, 'R' (RG-LRU) and 'W'
(RWKV6) recurrent blocks.

A port of the reference's ``models/lm.py``: the same parameter and cache
trees (a stacked ``groups`` axis over the repeating layer pattern plus an
unrolled ``rem`` list), with ``lax.scan`` over groups become a Python loop
over that axis.  Three entry points: ``lm_loss`` (train), ``lm_prefill``
(full sequence, builds the decode caches) and ``lm_decode`` (one token
against the caches).

Training runs each group under ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` of the group body) and reaches no kernel, since none
has a backward: ``apply_block`` passes ``train`` to every block, so
attention runs the plain ``attention_core``, the MoE FFN the reference's
expert einsums, the RG-LRU its Python time loop (``rglru_scan``) and the
WKV6 recurrence ``wkv_chunked`` / ``wkv_scan``, as the reference trains
them.  The code is the same on the CPU and on the card.  Prefill and
decode keep their kernels.

Decode writes its new state into the cache it is given, in place (the
reference returns fresh buffers): the K/V slot of 'A' and 'L' blocks, and
the whole state of 'R' and 'W' blocks (copied into the cache views).  Each
session owns its cache, so the copy the functional version makes would only
cost memory.  A block with a MoE FFN returns its auxiliary loss (every
other block None, so serving adds nothing); ``lm_loss`` sums it, prefill
and decode drop it.  Every entry point takes the reference's ``ctx``:
under a mesh the params, batch and caches are DTensors, its layout
constraints sit where the reference's do, a MoE FFN runs
``moe_ffn_sharded``, each kernel runs on the local shards
(``ShardCtx.local_call``), decode writes each rank's own cache shard in
place (``write_slot``, ``copy_into``), and every entry point runs in
``ctx.scope()``, where the plain tensors every rank makes alike
(positions, masks, fresh buffers) meet DTensors as replicated ones.
A config with leading dense layers (``first_dense_layers``, DeepSeek-V2)
keeps them unstacked under ``lead`` (params and caches), run before the
stacked groups; an MLA block (``cfg.kv_lora_rank``) caches one latent
leaf ``kv`` [B, cap, 1, kv_lora_rank + qk_rope_head_dim] instead of K and
V, serves on one device, and does not train.
The vision frontend is the reference's stub: a batch
may carry precomputed ``patch_embeds`` [B, P, D], projected by
``patch_proj`` and put before the text; the loss is taken over the text,
and prefill's caches hold P + S_text positions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..obs.spans import span
from . import rglru as rg
from . import rwkv as rw
from .layers import (
    BF16,
    F32,
    attention_block,
    attn_init,
    chunked_lm_loss,
    dense_init,
    embed_init,
    embed_lookup,
    logits_head,
    mla_decode,
    mla_init,
    mla_latent_width,
    mla_prefill,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    rope,
)
from .moe import moe_ffn, moe_ffn_sharded, moe_init
from .sharding import ShardCtx, copy_into, mm, reshape, unshard_dim, write_slot

_KINDS = ("A", "L", "R", "W")


def group_pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    return cfg.layer_pattern if cfg.layer_pattern else ("A",)


def group_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(stacked groups, unrolled remainder) of the layers after the leading
    dense ones."""
    g = len(group_pattern(cfg))
    n = cfg.num_layers - cfg.first_dense_layers
    return n // g, n % g


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a block kind this port does not have; past this check
    every block is 'A', 'L', 'R' or 'W'."""
    missing = [repr(k) for k in sorted(set(group_pattern(cfg))) if k not in _KINDS]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not ported")


# ---------------------------------------------------------------- init
def block_init(gen, kind: str, cfg: ArchConfig, lead=(), dense: bool = False):
    """One block's params; ``dense``: a leading dense layer (FFN width
    ``dense_d_ff``)."""
    dev = gen.device
    p = {"norm1": rmsnorm_init(cfg.d_model, dev, lead),
         "norm2": rmsnorm_init(cfg.d_model, dev, lead)}
    if kind in ("A", "L"):
        p["attn"] = (mla_init(gen, cfg, lead) if cfg.kv_lora_rank else
                     attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim, lead))
        if dense:
            p["ffn"] = mlp_init(gen, cfg.d_model, cfg.dense_d_ff, lead)
        elif cfg.num_experts:
            p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.num_experts, lead,
                                shared_d_ff=cfg.shared_d_ff)
        else:
            p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, lead)
    elif kind == "R":
        p["rglru"] = rg.rglru_init(gen, cfg.d_model, cfg.rnn_width, cfg.conv_width,
                                   lead)
        p["ffn"] = mlp_init(gen, cfg.d_model, cfg.d_ff, lead)
    elif kind == "W":
        p["tm"] = rw.timemix_init(gen, cfg.d_model, cfg.rwkv_head_dim, lead)
        p["cm"] = rw.channelmix_init(gen, cfg.d_model, cfg.d_ff, lead)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    return p


def lm_init(gen: torch.Generator, cfg: ArchConfig):
    """Params drawn from ``gen`` on its device (bf16, the reference's tree)."""
    check_supported(cfg)
    n_groups, rem = group_counts(cfg)
    pat = group_pattern(cfg)
    params: Dict = {}
    params.update(embed_init(gen, cfg.padded_vocab, cfg.d_model))
    if cfg.frontend == "vision":
        params["patch_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model))
    if cfg.first_dense_layers:
        params["lead"] = [block_init(gen, "A", cfg, dense=True)
                          for _ in range(cfg.first_dense_layers)]
    params["groups"] = {f"b{j}": block_init(gen, kind, cfg, lead=(n_groups,))
                        for j, kind in enumerate(pat)}
    params["rem"] = [block_init(gen, pat[i], cfg) for i in range(rem)]
    params["final_norm"] = rmsnorm_init(cfg.d_model, gen.device)
    params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), in_axis=0)
    return params


# ---------------------------------------------------------------- caches
def block_cache_init(kind: str, cfg: ArchConfig, batch: int, cap: int,
                     device, lead=()):
    """Decode-time cache for one block: K/V for 'A' (full) and 'L' (ring),
    the recurrent state for 'R' and 'W'."""
    if kind == "R":
        return rg.rglru_state_init(batch, cfg.rnn_width, cfg.conv_width, device, lead)
    if kind == "W":
        return rw.rwkv_state_init(batch, cfg.d_model, cfg.rwkv_head_dim, device, lead)
    if kind not in ("A", "L"):
        raise ValueError(kind)
    if cfg.kv_lora_rank:
        shape = tuple(lead) + (batch, cap, 1, mla_latent_width(cfg))
        return {"kv": torch.zeros(shape, dtype=BF16, device=device)}
    w = cap if kind == "A" else min(cfg.window_size or cap, cap)
    shape = tuple(lead) + (batch, w, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=BF16, device=device),
            "v": torch.zeros(shape, dtype=BF16, device=device)}


def lm_cache_init(cfg: ArchConfig, batch: int, cap: int, device="cuda"):
    check_supported(cfg)
    n_groups, rem = group_counts(cfg)
    pat = group_pattern(cfg)
    groups = {f"b{j}": block_cache_init(k, cfg, batch, cap, device, (n_groups,))
              for j, k in enumerate(pat)}
    rem_caches = [block_cache_init(pat[i], cfg, batch, cap, device)
                  for i in range(rem)]
    caches = {"groups": groups, "rem": rem_caches}
    if cfg.first_dense_layers:
        caches["lead"] = [block_cache_init("A", cfg, batch, cap, device)
                          for _ in range(cfg.first_dense_layers)]
    return caches


# ---------------------------------------------------------------- blocks
def _add_aux(total, aux):
    """Sum of MoE aux terms; None stands for the 0 of every other block, so
    serving launches nothing for it."""
    return aux if total is None else (total if aux is None else total + aux)


def _ffn_apply(bp, cfg: ArchConfig, h2, train: bool, ctx: ShardCtx = ShardCtx()):
    """Dense or MoE FFN on [B, S, D]; returns (out, aux), aux None when
    dense.  Under a mesh whose model axis divides the sequence and the
    experts, a MoE FFN runs expert-parallel (``moe_ffn_sharded``); under
    any other (a decode step) on each rank's block of the capacity buffer
    in serving (``moe_ffn``).  A leading dense layer's block has ``ffn``."""
    if "moe" in bp:
        B, S, D = h2.shape
        kw = dict(n_experts=cfg.num_experts, top_k=cfg.moe_top_k,
                  capacity_factor=cfg.capacity_factor)
        use_smap = (
            ctx.mesh is not None
            and S % max(1, ctx.tp) == 0 and S >= ctx.tp
            and cfg.num_experts % max(1, ctx.tp) == 0
        )
        if use_smap:
            return moe_ffn_sharded(bp["moe"], h2, ctx=ctx, train=train, **kw)
        out, aux = moe_ffn(bp["moe"], reshape(h2, B * S, D), train=train, ctx=ctx,
                           renorm=cfg.norm_topk_prob, dropless=cfg.dropless, **kw)
        return reshape(out, B, S, D), aux
    return mlp(bp["ffn"], h2, ctx=ctx), None


def _store(cache, new, mode: str):
    """Prefill returns the fresh state; decode copies it into the cache
    views it was given (the session's own buffers) and returns those;
    training keeps no state."""
    if mode == "train":
        return None
    if mode != "decode":
        return new
    for k, v in new.items():
        copy_into(cache[k], v)
    return cache


def _ring_positions(pos: int, cap: int, device=None):
    """Absolute position stored in each ring slot after writing at
    slot = pos % cap:  kpos[s] = pos - ((pos - s) mod cap); negative => empty."""
    s = torch.arange(cap, device=device)
    return pos - torch.remainder(pos - s, cap)


def apply_block(bp, kind: str, h, *, cfg: ArchConfig, positions, mode: str,
                cache=None, pos=None, chunk: int = 1024, ctx: ShardCtx = ShardCtx()):
    """One block.  Returns (h, aux, new_cache): aux is the MoE FFN's
    auxiliary loss (None for any other block), ``new_cache`` None in
    training."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    train = mode == "train"
    if kind == "R":
        state = cache if cache is not None else rg.rglru_state_init(
            h.shape[0], cfg.rnn_width, cfg.conv_width, h.device)
        hn = rmsnorm(bp["norm1"], h, cfg.norm_eps)
        out, new_state = rg.rglru_block_apply(bp["rglru"], hn, state, train=train,
                                              ctx=ctx)
        h = h + out
        h2 = rmsnorm(bp["norm2"], h, cfg.norm_eps)
        h = ctx.cstr(h + mlp(bp["ffn"], h2, ctx=ctx), "dp", "tp", None)
        return h, None, _store(cache, new_state, mode)
    if kind == "W":
        st = cache if cache is not None else rw.rwkv_state_init(
            h.shape[0], cfg.d_model, cfg.rwkv_head_dim, h.device)
        hn = rmsnorm(bp["norm1"], h, cfg.norm_eps)
        tm_out, shift_tm, S_new = rw.timemix_apply(bp["tm"], hn, st["shift_tm"],
                                                   st["S"], cfg.rwkv_head_dim,
                                                   train=train, ctx=ctx)
        # the row-parallel output's partial sums reduced here: their norm
        # would stay partial, and the channel mix's token shift cannot meet
        # a partial tensor on torch 2.11's DTensor
        h = ctx.cstr(h + tm_out, "dp", "tp", None)
        hn2 = rmsnorm(bp["norm2"], h, cfg.norm_eps)
        cm_out, shift_cm = rw.channelmix_apply(bp["cm"], hn2, st["shift_cm"])
        # split on the width as its column-parallel products give it, and
        # so its cotangent: one that came back split on the sequence would
        # be gathered whole before the products' weight grads
        cm_out = ctx.cstr(cm_out, "dp", None, "tp")
        new_state = {"S": S_new, "shift_tm": shift_tm, "shift_cm": shift_cm}
        h = ctx.cstr(h + cm_out, "dp", "tp", None)
        return h, None, _store(cache, new_state, mode)
    window = cfg.window_size if kind == "L" else 0
    # the norm output in the seq-sharded layout, as the reference has it
    hn = ctx.cstr(rmsnorm(bp["norm1"], h, cfg.norm_eps), "dp", "tp", None)
    if cfg.kv_lora_rank:
        if train or ctx.mesh is not None:
            raise NotImplementedError(f"{cfg.name}: latent attention serves on one "
                                      "device only; it does not train")
        if mode == "decode":
            attn_out = mla_decode(bp["attn"], hn, cache["kv"], cfg=cfg,
                                  positions=positions, pos=pos)
            new_cache = cache
        else:
            attn_out, lat = mla_prefill(bp["attn"], hn, cfg=cfg, positions=positions)
            new_cache = {"kv": lat}
    elif mode == "decode":
        B = h.shape[0]
        Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
        k_new = reshape(mm(hn, bp["attn"]["wk"]), B, 1, Hkv, Dh)
        v_new = reshape(mm(hn, bp["attn"]["wv"]), B, 1, Hkv, Dh)
        k_new = rope(k_new, positions, cfg.rope_theta)
        k_buf, v_buf = cache["k"], cache["v"]
        cap = k_buf.shape[1]
        slot = pos % cap if kind == "L" else min(pos, cap - 1)
        write_slot(k_buf, 1, slot, k_new[:, 0])
        write_slot(v_buf, 1, slot, v_new[:, 0])
        k_buf = ctx.cstr(k_buf, "dp", "tp", None, None)
        v_buf = ctx.cstr(v_buf, "dp", "tp", None, None)
        kpos = (_ring_positions(pos, cap, h.device) if kind == "L"
                else torch.arange(cap, device=h.device))
        attn_out, _ = attention_block(
            bp["attn"], hn, cfg=cfg, positions=positions, causal=True,
            window=window, kv_override=(k_buf, v_buf, kpos), chunk=chunk, ctx=ctx)
        new_cache = cache
    else:
        attn_out, (k_full, v_full) = attention_block(
            bp["attn"], hn, cfg=cfg, positions=positions, causal=True,
            window=window, chunk=chunk, use_kernel=not train, ctx=ctx)
        S = h.shape[1]
        if train:
            new_cache = None
        elif kind == "L":
            # ring slot (S - w + i) % w holds tail position i: every slot
            # is written, so the ring is the tail in the order ``order``
            w = min(cfg.window_size, S)
            order = torch.remainder(torch.arange(w, device=h.device) - (S - w), w)
            new_cache = {"k": k_full[:, S - w:].index_select(1, order),
                         "v": v_full[:, S - w:].index_select(1, order)}
        else:
            new_cache = {"k": ctx.cstr(k_full, "dp", "tp", None, None),
                         "v": ctx.cstr(v_full, "dp", "tp", None, None)}
    h = ctx.cstr(h + attn_out, "dp", "tp", None)
    h2 = ctx.cstr(rmsnorm(bp["norm2"], h, cfg.norm_eps), "dp", "tp", None)
    ffn_out, aux = _ffn_apply(bp, cfg, h2, train, ctx)
    return ctx.cstr(h + ffn_out, "dp", "tp", None), aux, new_cache


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int):
    """The ``n`` slices of a stacked tree along its leading axis, one
    ``torch.unbind`` a leaf: in backward each leaf's slice grads are
    stacked once (indexing slice by slice would add ``n`` full-size grads)."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    return torch.unbind(unshard_dim(tree, 0), 0)


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------- forward
def _run_stack(params, h, *, cfg, positions, mode, caches=None, pos=None,
               chunk=1024, ctx: ShardCtx = ShardCtx()):
    """Loop over the stacked groups, then the unrolled remainder.
    Returns (h, aux, caches): the MoE aux summed block by block in layer
    order (None without MoE blocks); fresh caches in prefill, ``caches``
    updated in place in decode, None in training, where each group is
    recomputed in backward."""
    pat = group_pattern(cfg)
    n_groups, rem = group_counts(cfg)

    def group(h, aux, gp, gcache):
        new = {}
        for j, kind in enumerate(pat):
            bcache = gcache[f"b{j}"] if gcache is not None else None
            h, a, new[f"b{j}"] = apply_block(
                gp[f"b{j}"], kind, h, cfg=cfg, positions=positions, mode=mode,
                cache=bcache, pos=pos, chunk=chunk, ctx=ctx)
            aux = _add_aux(aux, a)
        return h, aux, new

    aux = None
    lead_caches = []
    for i, bp in enumerate(params.get("lead", [])):
        bcache = caches["lead"][i] if caches is not None else None
        h, _, nc = apply_block(bp, "A", h, cfg=cfg, positions=positions, mode=mode,
                               cache=bcache, pos=pos, chunk=chunk, ctx=ctx)
        lead_caches.append(nc)
    built = {f"b{j}": [] for j in range(len(pat))}
    for g, gp in enumerate(_unbind(params["groups"], n_groups)):
        if mode == "train":
            h, aux = checkpoint(lambda h, aux, gp=gp: group(h, aux, gp, None)[:2],
                                h, aux, use_reentrant=False)
            continue
        gcache = _index(caches["groups"], g) if caches is not None else None
        h, aux, new = group(h, aux, gp, gcache)
        if mode == "prefill":
            for k, nc in new.items():
                built[k].append(nc)
    rem_caches = []
    for i in range(rem):
        bcache = caches["rem"][i] if caches is not None else None
        h, a, nc = apply_block(params["rem"][i], pat[i], h, cfg=cfg,
                               positions=positions, mode=mode, cache=bcache,
                               pos=pos, chunk=chunk, ctx=ctx)
        aux = _add_aux(aux, a)
        rem_caches.append(nc)
    if mode == "train":
        return h, aux, None
    if mode == "decode":
        return h, aux, caches
    groups = {k: _stack(v) for k, v in built.items()} if n_groups else {}
    out = {"groups": groups, "rem": rem_caches}
    if lead_caches:
        out["lead"] = lead_caches
    return h, aux, out


def _embed(params, tokens):
    return embed_lookup(params, tokens).to(BF16)


def _embed_input(params, batch, cfg: ArchConfig, ctx: ShardCtx = ShardCtx()):
    """Tokens (after the projected ``patch_embeds`` of a vision config, when
    the batch has them) -> ([B, S, D], offset of the first text position)."""
    tok_h = _embed(params, batch["tokens"])
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        patches = batch["patch_embeds"]
        patch_h = mm(patches.to(BF16), params["patch_proj"])
        h, off = torch.cat([patch_h, tok_h], dim=1), patches.shape[1]
    else:
        h, off = tok_h, 0
    return ctx.cstr(h, "dp", "tp", None), off


def lm_loss(params, batch, cfg: ArchConfig, ctx: ShardCtx = ShardCtx(),
            chunk: int = 1024):
    """Next-token loss over the text.  batch: {tokens [B, S_text]
    (+ patch_embeds [B, P, D])}.  Returns (loss + 0.01 * aux,
    {"loss", "aux"})."""
    check_supported(cfg)
    with ctx.scope():
        tokens = batch["tokens"]
        h, off = _embed_input(params, batch, cfg, ctx)
        positions = torch.arange(h.shape[1], device=h.device)
        h, aux, _ = _run_stack(params, h, cfg=cfg, positions=positions,
                               mode="train", chunk=chunk, ctx=ctx)
        if aux is None:
            aux = ctx.replicate(torch.zeros((), dtype=F32, device=h.device))
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)[:, off:, :]
        loss = chunked_lm_loss(params, h[:, :-1, :], tokens[:, 1:], cfg.vocab_size,
                               ctx=ctx)
        return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def lm_prefill(params, batch, cfg: ArchConfig, ctx: ShardCtx = ShardCtx(),
               chunk: int = 1024):
    """Full-sequence forward building decode caches.  batch: {tokens [B, S]
    (+ patch_embeds [B, P, D]: the caches then hold P + S positions)}.
    Returns (logits_last [B, V], caches)."""
    check_supported(cfg)
    with ctx.scope():
        h, _ = _embed_input(params, batch, cfg, ctx)
        positions = torch.arange(h.shape[1], device=h.device)
        h, _, caches = _run_stack(params, h, cfg=cfg, positions=positions,
                                  mode="prefill", chunk=chunk, ctx=ctx)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = logits_head(params, h[:, -1:, :], cfg.vocab_size)
        return logits[:, 0, :], caches


def lm_decode(params, batch, cfg: ArchConfig, ctx: ShardCtx = ShardCtx()):
    """One decode step.  batch: {token [B], pos int, caches}.  Returns
    (logits [B, V], caches) with the caches updated in place.  Runs in the
    span ``model.decode``."""
    check_supported(cfg)
    tok = batch["token"]
    pos = int(batch["pos"])
    with span("model.decode"), ctx.scope():
        h = _embed(params, tok)[:, None, :]
        positions = torch.full((1,), pos, dtype=torch.int64, device=h.device)
        h, _, caches = _run_stack(params, h, cfg=cfg, positions=positions,
                                  mode="decode", caches=batch["caches"], pos=pos,
                                  ctx=ctx)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = logits_head(params, h[:, 0, :], cfg.vocab_size)
        return logits, caches
