"""Whisper-style encoder-decoder on torch (arXiv:2212.04356).

A port of the reference's ``models/encdec.py``.  The conv audio frontend
is a stub there too: the input is precomputed frame embeddings
[B, S_audio, D].  Encoder: bidirectional attention, learned positions, no
RoPE.  Decoder: causal self-attention, then cross-attention over the
encoder output, text length = S_audio // 8 for train and prefill.

The parameter tree is the reference's, the per-layer blocks stacked on a
leading layer axis (``enc``, ``dec``) as its ``jax.vmap`` init leaves them;
``lax.scan`` over that axis becomes a Python loop.  In prefill the three
attentions of a layer pair (the encoder's, the decoder's causal
self-attention and its cross-attention over the whole encoder output) run
the flash-attention kernel.  Training recomputes each encoder and decoder
layer in backward (``torch.utils.checkpoint``, the reference's
``jax.checkpoint`` of both scans) and runs its attention through the plain
``attention_core``.  Decode writes the new self K/V into the caches it is
given, in place, at ``min(pos, cap - 1)``, as ``lm_decode`` does.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..obs.spans import span
from .layers import (
    BF16,
    attention_block,
    attn_init,
    chunked_lm_loss,
    dense_init,
    embed_lookup,
    logits_head,
    mlp,
    mlp_init,
    rmsnorm,
    rmsnorm_init,
)
from .lm import _index, _stack, _unbind
from .sharding import ShardCtx, gather_inner, mm, reshape, write_slot

TEXT_RATIO = 8  # decoder text length = audio frames // 8 (train/prefill)


def text_len(seq_len: int) -> int:
    return max(8, seq_len // TEXT_RATIO)


# ---------------------------------------------------------------- init
def _enc_block_init(gen, cfg: ArchConfig, lead=()):
    dev = gen.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dev, lead),
        "norm2": rmsnorm_init(cfg.d_model, dev, lead),
        "attn": attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim, lead),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, lead),
    }


def _dec_block_init(gen, cfg: ArchConfig, lead=()):
    dev = gen.device
    return {
        "norm1": rmsnorm_init(cfg.d_model, dev, lead),
        "norm2": rmsnorm_init(cfg.d_model, dev, lead),
        "norm3": rmsnorm_init(cfg.d_model, dev, lead),
        "self_attn": attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                               cfg.head_dim, lead),
        "cross_attn": attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim, lead),
        "ffn": mlp_init(gen, cfg.d_model, cfg.d_ff, lead),
    }


def encdec_init(gen: torch.Generator, cfg: ArchConfig, max_pos: int = 1 << 16):
    """Params drawn from ``gen`` on its device (bf16, the reference's tree)."""
    d, dev = cfg.d_model, gen.device
    return {
        "embed": dense_init(gen, (cfg.padded_vocab, d), in_axis=1),
        "pos_embed_enc": dense_init(gen, (max_pos, d), in_axis=1),
        "pos_embed_dec": dense_init(gen, (max_pos, d), in_axis=1),
        "enc": _enc_block_init(gen, cfg, lead=(cfg.encoder_layers,)),
        "dec": _dec_block_init(gen, cfg, lead=(cfg.decoder_layers,)),
        "enc_norm": rmsnorm_init(d, dev),
        "final_norm": rmsnorm_init(d, dev),
        "lm_head": dense_init(gen, (d, cfg.padded_vocab)),
    }


def encdec_cache_init(cfg: ArchConfig, batch: int, cap: int, enc_len: int,
                      device="cuda"):
    L, Hkv, Dh = cfg.decoder_layers, cfg.num_kv_heads, cfg.head_dim

    def z(n):
        return torch.zeros((L, batch, n, Hkv, Dh), dtype=BF16, device=device)

    return {"k": z(cap), "v": z(cap), "ck": z(enc_len), "cv": z(enc_len)}


# ---------------------------------------------------------------- encoder
def _enc_layer(bp, h, cfg: ArchConfig, positions, chunk: int, use_kernel: bool,
               ctx: ShardCtx = ShardCtx()):
    hn = rmsnorm(bp["norm1"], h, cfg.norm_eps)
    attn_out, _ = attention_block(bp["attn"], hn, cfg=cfg, positions=positions,
                                  causal=False, use_rope=False, chunk=chunk,
                                  use_kernel=use_kernel, ctx=ctx)
    h = h + attn_out
    h2 = rmsnorm(bp["norm2"], h, cfg.norm_eps)
    return ctx.cstr(h + mlp(bp["ffn"], h2, ctx=ctx), "dp", "tp", None)


def encode(params, audio_embeds, cfg: ArchConfig, chunk: int = 1024,
           train: bool = False, ctx: ShardCtx = ShardCtx()):
    """[B, S, D] frame embeddings -> encoder output [B, S, D].  ``train``
    recomputes each layer in backward and keeps attention off the kernel."""
    S = audio_embeds.shape[1]
    h = audio_embeds.to(BF16) + params["pos_embed_enc"][:S][None]
    h = ctx.cstr(h, "dp", "tp", None)
    positions = torch.arange(S, device=h.device)
    for bp in _unbind(params["enc"], cfg.encoder_layers):
        if train:
            h = checkpoint(lambda h, bp=bp: _enc_layer(bp, h, cfg, positions, chunk,
                                                       False, ctx),
                           h, use_reentrant=False)
        else:
            h = _enc_layer(bp, h, cfg, positions, chunk, True, ctx)
    return rmsnorm(params["enc_norm"], h, cfg.norm_eps)


# ---------------------------------------------------------------- decoder
def _dec_layer(bp, h, *, cfg: ArchConfig, positions, mode: str, enc_out=None,
               cache=None, pos=None, chunk: int = 1024, ctx: ShardCtx = ShardCtx()):
    """One decoder layer.  Returns (h, new_cache): the layer's self and
    cross K/V in prefill, ``cache`` (written in place) in decode, None in
    training."""
    B = h.shape[0]
    Hkv, Dh = cfg.num_kv_heads, cfg.head_dim
    use_kernel = mode != "train"
    hn = rmsnorm(bp["norm1"], h, cfg.norm_eps)
    new_cache = None
    if mode == "decode":
        k_buf, v_buf = cache["k"], cache["v"]
        cap = k_buf.shape[1]
        slot = min(pos, cap - 1)
        write_slot(k_buf, 1, slot, reshape(mm(hn, bp["self_attn"]["wk"]), B, Hkv, Dh))
        write_slot(v_buf, 1, slot, reshape(mm(hn, bp["self_attn"]["wv"]), B, Hkv, Dh))
        attn_out, _ = attention_block(
            bp["self_attn"], hn, cfg=cfg, positions=positions, causal=True,
            use_rope=False, kv_override=(k_buf, v_buf, torch.arange(cap, device=h.device)),
            chunk=chunk, ctx=ctx)
        ck, cv = cache["ck"], cache["cv"]
        new_cache = cache
    else:
        attn_out, (k_self, v_self) = attention_block(
            bp["self_attn"], hn, cfg=cfg, positions=positions, causal=True,
            use_rope=False, chunk=chunk, use_kernel=use_kernel, ctx=ctx)
        Se = enc_out.shape[1]
        enc_out = gather_inner(enc_out)     # read by both cross projections
        ck = reshape(mm(enc_out, bp["cross_attn"]["wk"]), B, Se, Hkv, Dh)
        cv = reshape(mm(enc_out, bp["cross_attn"]["wv"]), B, Se, Hkv, Dh)
        if mode == "prefill":
            new_cache = {"k": k_self, "v": v_self, "ck": ck, "cv": cv}
    h = h + attn_out
    h2 = rmsnorm(bp["norm2"], h, cfg.norm_eps)
    # cross-attention masks nothing: every encoder position is a valid key
    cross_out, _ = attention_block(
        bp["cross_attn"], h2, cfg=cfg, positions=positions, causal=False,
        use_rope=False, kv_override=(ck, cv, torch.arange(ck.shape[1], device=h.device)),
        full_kv=True, chunk=chunk, use_kernel=use_kernel, ctx=ctx)
    h = h + cross_out
    h3 = rmsnorm(bp["norm3"], h, cfg.norm_eps)
    return ctx.cstr(h + mlp(bp["ffn"], h3, ctx=ctx), "dp", "tp", None), new_cache


def _decoder_stack(params, h, enc_out, cfg: ArchConfig, mode: str, caches=None,
                   pos=None, chunk: int = 1024, ctx: ShardCtx = ShardCtx()):
    """Loop over the stacked decoder layers.  caches (decode): {'k', 'v'
    self [L, B, cap, ..], 'ck', 'cv' cross [L, B, enc_len, ..]}.  Returns
    (h, caches): fresh stacked caches in prefill, ``caches`` updated in
    place in decode, None in training."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"mode must be 'train', 'prefill' or 'decode', got {mode!r}")
    if mode == "decode":
        positions = torch.full((1,), pos, dtype=torch.int64, device=h.device)
    else:
        positions = torch.arange(h.shape[1], device=h.device)
    if mode != "decode":
        # the first layer's input laid out as every later layer's is (the
        # reference's scan carry takes the layout of its body's output)
        h = ctx.cstr(h, "dp", "tp", None)
    built = []
    for i, bp in enumerate(_unbind(params["dec"], cfg.decoder_layers)):
        if mode == "train":
            h = checkpoint(
                lambda h, enc_out, bp=bp: _dec_layer(
                    bp, h, cfg=cfg, positions=positions, mode="train",
                    enc_out=enc_out, chunk=chunk, ctx=ctx)[0],
                h, enc_out, use_reentrant=False)
            continue
        cache = _index(caches, i) if caches is not None else None
        h, new = _dec_layer(bp, h, cfg=cfg, positions=positions, mode=mode,
                            enc_out=enc_out, cache=cache, pos=pos, chunk=chunk,
                            ctx=ctx)
        built.append(new)
    if mode == "prefill":
        return h, _stack(built)
    return h, (caches if mode == "decode" else None)


def _embed_text(params, tokens):
    S = tokens.shape[1]
    return embed_lookup(params, tokens).to(BF16) + params["pos_embed_dec"][:S][None]


# ---------------------------------------------------------------- entry points
def encdec_loss(params, batch, cfg: ArchConfig, ctx: ShardCtx = ShardCtx(),
                chunk: int = 1024):
    """Next-token loss.  batch: {audio_embeds [B, Sa, D], tokens [B, St]}.
    Returns (loss, {"loss"})."""
    with ctx.scope():
        enc_out = encode(params, batch["audio_embeds"], cfg, chunk, train=True,
                         ctx=ctx)
        tok = batch["tokens"]
        h, _ = _decoder_stack(params, _embed_text(params, tok), enc_out, cfg,
                              "train", chunk=chunk, ctx=ctx)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        loss = chunked_lm_loss(params, h[:, :-1, :], tok[:, 1:], cfg.vocab_size,
                               ctx=ctx)
        return loss, {"loss": loss}


def encdec_prefill(params, batch, cfg: ArchConfig, ctx: ShardCtx = ShardCtx(),
                   chunk: int = 1024):
    """Encoder plus decoder over the prompt.  batch: {audio_embeds, tokens}.
    Returns (logits_last [B, V], caches): self K/V of length St, cross K/V
    of length Sa, each [L, B, .., Hkv, Dh]."""
    with ctx.scope():
        enc_out = encode(params, batch["audio_embeds"], cfg, chunk, ctx=ctx)
        h, caches = _decoder_stack(params, _embed_text(params, batch["tokens"]),
                                   enc_out, cfg, "prefill", chunk=chunk, ctx=ctx)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        logits = logits_head(params, h[:, -1:, :], cfg.vocab_size)
        return logits[:, 0, :], caches


def encdec_decode(params, batch, cfg: ArchConfig, ctx: ShardCtx = ShardCtx()):
    """One decode step.  batch: {token [B], pos int, caches {k, v, ck, cv}}.
    Returns (logits [B, V], caches) with the caches updated in place.  Runs
    in the span ``model.decode``."""
    tok = batch["token"]
    pos = int(batch["pos"])
    with span("model.decode"), ctx.scope():
        h = (embed_lookup(params, tok)[:, None, :].to(BF16)
             + params["pos_embed_dec"][pos][None, None])
        h, caches = _decoder_stack(params, h, None, cfg, "decode",
                                   caches=batch["caches"], pos=pos, ctx=ctx)
        h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
        return logits_head(params, h[:, 0, :], cfg.vocab_size), caches
