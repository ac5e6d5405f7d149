"""Decoder-only LM on torch for 'A' (full) and 'L' (windowed) attention
blocks with dense FFNs.

A port of the reference's ``models/lm.py``: the same parameter and cache
trees (a stacked ``groups`` axis over the repeating layer pattern plus an
unrolled ``rem`` list), with ``lax.scan`` over groups become a Python loop
over that axis.  Two entry points: ``lm_prefill`` (full sequence, builds the
decode caches) and ``lm_decode`` (one token against the caches).

Decode writes the new K/V slot into the cache it is given, in place (the
reference returns fresh buffers): each session owns its cache, so the copy
the functional version makes would only cost memory.  'R' (RG-LRU), 'W'
(RWKV6), MoE FFNs and the vision frontend are not ported yet and raise.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..configs.base import ArchConfig
from .layers import (
    BF16,
    attention_block,
    attn_init,
    dense_init,
    embed_init,
    embed_lookup,
    logits_head,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
    rope,
)

_NOT_PORTED = {
    "moe": "MoE FFN (ROADMAP C1)",
    "R": "RG-LRU block 'R' (ROADMAP C2)",
    "W": "RWKV6 block 'W' (ROADMAP C3)",
    "vision": "vision frontend (ROADMAP C5)",
}


def group_pattern(cfg: ArchConfig) -> Tuple[str, ...]:
    return cfg.layer_pattern if cfg.layer_pattern else ("A",)


def group_counts(cfg: ArchConfig) -> Tuple[int, int]:
    g = len(group_pattern(cfg))
    return cfg.num_layers // g, cfg.num_layers % g


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the parts of the reference LM this port does not have yet;
    past this check every block is 'A' or 'L' with a dense FFN."""
    missing = []
    if cfg.num_experts:
        missing.append(_NOT_PORTED["moe"])
    if cfg.frontend == "vision":
        missing.append(_NOT_PORTED["vision"])
    missing += [_NOT_PORTED.get(k, repr(k)) for k in sorted(set(group_pattern(cfg)))
                if k not in ("A", "L")]
    if missing:
        raise NotImplementedError(f"{cfg.name}: {', '.join(missing)} not ported")


# ---------------------------------------------------------------- init
def block_init(gen, kind: str, cfg: ArchConfig, lead=()):
    dev = gen.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dev, lead),
        "norm2": rmsnorm_init(cfg.d_model, dev, lead),
        "attn": attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, lead),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, lead),
    }


def lm_init(gen: torch.Generator, cfg: ArchConfig):
    """Params drawn from ``gen`` on its device (bf16, the reference's tree)."""
    check_supported(cfg)
    n_groups, rem = group_counts(cfg)
    pat = group_pattern(cfg)
    params: Dict = {}
    params.update(embed_init(gen, cfg.padded_vocab, cfg.d_model))
    params["groups"] = {f"b{j}": block_init(gen, kind, cfg, lead=(n_groups,))
                        for j, kind in enumerate(pat)}
    params["rem"] = [block_init(gen, pat[i], cfg) for i in range(rem)]
    params["final_norm"] = rmsnorm_init(cfg.d_model, gen.device)
    params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), in_axis=0)
    return params


# ---------------------------------------------------------------- caches
def block_cache_init(kind: str, cfg: ArchConfig, batch: int, cap: int,
                     device, lead=()):
    """Decode-time cache for one 'A' (full) or 'L' (ring) block."""
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
    return {"groups": groups, "rem": rem_caches}


# ---------------------------------------------------------------- blocks
def _ring_positions(pos: int, cap: int, device=None):
    """Absolute position stored in each ring slot after writing at
    slot = pos % cap:  kpos[s] = pos - ((pos - s) mod cap); negative => empty."""
    s = torch.arange(cap, device=device)
    return pos - torch.remainder(pos - s, cap)


def apply_block(bp, kind: str, h, *, cfg: ArchConfig, positions, mode: str,
                cache=None, pos=None, chunk: int = 1024):
    """One 'A' or 'L' block.  Returns (h, new_cache)."""
    window = cfg.window_size if kind == "L" else 0
    hn = rmsnorm(bp["norm1"], h, cfg.norm_eps)
    if mode == "decode":
        B = h.shape[0]
        Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
        k_new = (hn @ bp["attn"]["wk"]).reshape(B, 1, Hkv, Dh)
        v_new = (hn @ bp["attn"]["wv"]).reshape(B, 1, Hkv, Dh)
        k_new = rope(k_new, positions, cfg.rope_theta)
        k_buf, v_buf = cache["k"], cache["v"]
        cap = k_buf.shape[1]
        slot = pos % cap if kind == "L" else min(pos, cap - 1)
        k_buf[:, slot] = k_new[:, 0]
        v_buf[:, slot] = v_new[:, 0]
        kpos = (_ring_positions(pos, cap, h.device) if kind == "L"
                else torch.arange(cap, device=h.device))
        attn_out, _ = attention_block(
            bp["attn"], hn, cfg=cfg, positions=positions, causal=True,
            window=window, kv_override=(k_buf, v_buf, kpos), chunk=chunk)
        new_cache = cache
    elif mode == "prefill":
        attn_out, (k_full, v_full) = attention_block(
            bp["attn"], hn, cfg=cfg, positions=positions, causal=True,
            window=window, chunk=chunk)
        S = h.shape[1]
        if kind == "L":
            w = min(cfg.window_size, S)
            slots = torch.remainder(torch.arange(S - w, S, device=h.device), w)
            k_ring = torch.zeros_like(k_full[:, :w])
            v_ring = torch.zeros_like(v_full[:, :w])
            k_ring[:, slots] = k_full[:, S - w:]
            v_ring[:, slots] = v_full[:, S - w:]
            new_cache = {"k": k_ring, "v": v_ring}
        else:
            new_cache = {"k": k_full, "v": v_full}
    else:
        raise ValueError(f"mode must be 'prefill' or 'decode', got {mode!r}")
    h = h + attn_out
    h2 = rmsnorm(bp["norm2"], h, cfg.norm_eps)
    h = h + mlp(bp["ffn"], h2)
    return h, new_cache


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ---------------------------------------------------------------- forward
def _run_stack(params, h, *, cfg, positions, mode, caches=None, pos=None,
               chunk=1024):
    """Loop over the stacked groups, then the unrolled remainder.
    Returns (h, caches): fresh caches in prefill, ``caches`` updated in place
    in decode."""
    pat = group_pattern(cfg)
    n_groups, rem = group_counts(cfg)
    built = {f"b{j}": [] for j in range(len(pat))}
    for g in range(n_groups):
        gp = _index(params["groups"], g)
        gcache = _index(caches["groups"], g) if caches is not None else None
        for j, kind in enumerate(pat):
            bcache = gcache[f"b{j}"] if gcache is not None else None
            h, nc = apply_block(gp[f"b{j}"], kind, h, cfg=cfg, positions=positions,
                                mode=mode, cache=bcache, pos=pos, chunk=chunk)
            if mode == "prefill":
                built[f"b{j}"].append(nc)
    rem_caches = []
    for i in range(rem):
        bcache = caches["rem"][i] if caches is not None else None
        h, nc = apply_block(params["rem"][i], pat[i], h, cfg=cfg,
                            positions=positions, mode=mode, cache=bcache,
                            pos=pos, chunk=chunk)
        rem_caches.append(nc)
    if mode == "decode":
        return h, caches
    groups = {k: _stack(v) for k, v in built.items()} if n_groups else {}
    return h, {"groups": groups, "rem": rem_caches}


def _embed(params, tokens):
    return embed_lookup(params, tokens).to(BF16)


def lm_prefill(params, batch, cfg: ArchConfig, chunk: int = 1024):
    """Full-sequence forward building decode caches.  batch: {tokens [B, S]}.
    Returns (logits_last [B, V], caches)."""
    check_supported(cfg)
    h = _embed(params, batch["tokens"])
    positions = torch.arange(h.shape[1], device=h.device)
    h, caches = _run_stack(params, h, cfg=cfg, positions=positions,
                           mode="prefill", chunk=chunk)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = logits_head(params, h[:, -1:, :], cfg.vocab_size)
    return logits[:, 0, :], caches


def lm_decode(params, batch, cfg: ArchConfig):
    """One decode step.  batch: {token [B], pos int, caches}.  Returns
    (logits [B, V], caches) with the caches updated in place."""
    check_supported(cfg)
    tok = batch["token"]
    pos = int(batch["pos"])
    h = _embed(params, tok)[:, None, :]
    positions = torch.full((1,), pos, dtype=torch.int64, device=h.device)
    h, caches = _run_stack(params, h, cfg=cfg, positions=positions,
                           mode="decode", caches=batch["caches"], pos=pos)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = logits_head(params, h[:, 0, :], cfg.vocab_size)
    return logits, caches
