"""Shared model layers on torch: norms, RoPE, GQA attention (direct and
chunked online-softmax), SwiGLU MLP, embeddings, LM head.

A port of the reference's ``models/layers.py``, with its ``ShardCtx``
layout constraints (``ctx.cstr``) where the reference places them: under a
mesh the tensors are DTensors and each constraint redistributes one, a
no-op on one device.  Layouts are the reference's (``[B, S, H, D]`` for
attention).  Attention accumulates in fp32 from bf16
operands, as the reference's ``preferred_element_type=f32`` einsums do: the
operands are upcast (bf16 products are exact in fp32) and summed in fp32.
Prefill attention, and cross-attention over a whole encoder output, goes
through the flash-attention kernel (``kernels.flash_attention``); decode
stays on the direct path, because the kernel takes no key positions and
cannot read a partly filled or ring cache.
Training stays on ``attention_core`` too (``use_kernel=False``), as the
reference trains through its jnp attention: the kernel has no backward.
Under a mesh the kernel runs on each rank's local shards
(``ShardCtx.local_call``): the batch and, when they divide over 'tp', the
query heads stay sharded, and each rank takes the KV heads its own query
heads read (``_kv_span``); when the heads do not divide, a prefill's query
stays split on the sequence over 'tp', as the reference lays it out, and
each rank runs its own rows from their own first position (K3's
``q_offset``); a decode step there attends each rank's own slots of the
capacity-sharded cache, combined over 'tp' as a split-KV softmax.
The scores, mask and softmax, and the kernel's call, run in the
``record_function`` region "attn_scores", the reference's named scope,
which the cost model reads (``launch/op_analysis.py``); it is opened
through ``obs.spans.span``, so only a profiler or a dispatch mode pays
for it.
The loss functions (``softmax_xent``, ``chunked_lm_loss``) close the file.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.flash_attention.ops import flash_attention
from ..obs.spans import span
from .sharding import (ShardCtx, gather_inner, gather_last, is_dtensor, mm, reshape,
                       unshard_dim)

F32 = torch.float32
BF16 = torch.bfloat16
NEG_INF = -1e30


def dense_init(gen: torch.Generator, shape, in_axis=0, dtype=BF16, lead=()):
    """Normal / sqrt(fan_in) weights drawn from ``gen``, on its device.

    ``lead`` prepends stacking axes (the layer stack's ``groups`` axis) that
    do not count toward the fan-in.
    """
    if isinstance(in_axis, int):
        fan_in = shape[in_axis]
    else:
        fan_in = int(math.prod(shape[a] for a in in_axis))
    w = torch.randn(tuple(lead) + tuple(shape), generator=gen, dtype=F32,
                    device=gen.device)
    return (w / math.sqrt(max(1, fan_in))).to(dtype)


# ----------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, device=None, lead=()):
    return {"scale": torch.ones(tuple(lead) + (d,), dtype=BF16, device=device)}


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * p["scale"]


# -------------------------------------------------------------------- RoPE
def rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [S] or [..., S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=x.device) / half)
    ang = positions.to(F32)[..., None] * freqs                          # [..., S, half]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half].to(F32), x[..., half:].to(F32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------- attention (GQA)
def attn_init(gen, d_model: int, n_heads: int, n_kv: int, head_dim: int,
              lead=()):
    return {
        "wq": dense_init(gen, (d_model, n_heads * head_dim), lead=lead),
        "wk": dense_init(gen, (d_model, n_kv * head_dim), lead=lead),
        "wv": dense_init(gen, (d_model, n_kv * head_dim), lead=lead),
        "wo": dense_init(gen, (n_heads * head_dim, d_model), lead=lead),
    }


def _mask_bias(qpos, kpos, causal: bool, window: int):
    """[Sq, Skv] additive mask (0 allowed / NEG_INF blocked)."""
    ok = kpos[None, :] >= 0
    if causal:
        ok = ok & (kpos[None, :] <= qpos[:, None])
    if window:
        ok = ok & (kpos[None, :] > qpos[:, None] - window)
    zero = torch.zeros((), dtype=F32, device=ok.device)
    return torch.where(ok, zero, torch.full((), NEG_INF, dtype=F32, device=ok.device))


def _repeat_kv(x, rep: int):
    if rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, rep, d).reshape(b, s, h * rep, d)


def attention_core(q, k, v, qpos, kpos, *, causal: bool = True, window: int = 0,
                   chunk: int = 1024, ctx: ShardCtx = ShardCtx()):
    """q: [B, Sq, H, Dh]; k, v: [B, Skv, Hkv, Dh]; qpos: [Sq]; kpos: [Skv].

    Direct path for Sq == 1 (decode) or Skv <= chunk; otherwise the chunked
    online softmax, whose transient is [B, H, Sq, chunk] fp32.  Under grad
    mode each chunk is recomputed in backward (the reference's per-chunk
    ``jax.checkpoint``) instead of keeping its scores for it.  Under a mesh
    it runs on each rank's heads or sequence rows (``_on_rank_heads``), as
    the kernel does; a decode step whose heads do not divide over 'tp' runs
    on each rank's own cache slots (``_on_rank_slots``).
    """
    if q.shape[1] == 1 and ctx.mesh is not None and q.shape[2] % ctx.tp:
        return _on_rank_slots(q, k, v, qpos, kpos, causal, window, ctx)
    return _on_rank_heads(
        lambda q, k, v, first: _attention(q, k, v, qpos[first:first + q.shape[1]], kpos,
                                          causal, window, chunk),
        q, k, v, ctx)


def _attention(q, k, v, qpos, kpos, causal: bool, window: int, chunk: int):
    """``attention_core`` on plain tensors."""
    B, Sq, H, Dh = q.shape
    _, Skv, Hkv, _ = k.shape
    rep = H // Hkv
    scale = Dh ** -0.5

    if Sq == 1 or Skv <= chunk:
        with span("attn_scores"):     # region of the cost model
            kk, vv = _repeat_kv(k, rep), _repeat_kv(v, rep)
            s = torch.einsum("bqhd,bkhd->bhqk", q.to(F32), kk.to(F32)) * scale
            s = s + _mask_bias(qpos, kpos, causal, window)[None, None]
            p = torch.softmax(s, dim=-1)
            o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).to(F32), vv.to(F32))
            return o.to(q.dtype)

    assert Skv % chunk == 0, (Skv, chunk)
    o = torch.zeros((B, H, Sq, Dh), dtype=F32, device=q.device)
    m = torch.full((B, H, Sq), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=F32, device=q.device)
    qf = q.to(F32)

    def body(o, m, l, kc, vc, kp):
        with span("attn_scores"):     # so is its recompute
            kc, vc = _repeat_kv(kc, rep), _repeat_kv(vc, rep)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kc.to(F32)) * scale
            s = s + _mask_bias(qpos, kp, causal, window)[None, None]
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            o = o * alpha[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", p.to(vc.dtype).to(F32), vc.to(F32))
            return o, m_new, l

    for start in range(0, Skv, chunk):
        args = (o, m, l, k[:, start:start + chunk], v[:, start:start + chunk],
                kpos[start:start + chunk])
        o, m, l = (checkpoint(body, *args, use_reentrant=False)
                   if torch.is_grad_enabled() else body(*args))
    out = (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    return out.permute(0, 2, 1, 3).contiguous()  # [B, Sq, H, Dh]


def _partial_attention(q, k, v, qpos, kpos, causal: bool, window: int):
    """One rank's part of a split-KV softmax, on plain tensors: (o = the
    sum of p * v [B, Sq, H, Dh], the row max m and the sum l of p [B, Sq,
    H], all f32), p = exp(s - m) over the keys given (none: m = NEG_INF)."""
    B, Sq, H, Dh = q.shape
    with span("attn_scores"):     # region of the cost model
        if k.shape[1] == 0:
            zero = torch.zeros((B, Sq, H), dtype=F32, device=q.device)
            return (torch.zeros((B, Sq, H, Dh), dtype=F32, device=q.device),
                    zero + NEG_INF, zero)
        rep = H // k.shape[2]
        kk, vv = _repeat_kv(k, rep), _repeat_kv(v, rep)
        s = torch.einsum("bqhd,bkhd->bqhk", q.to(F32), kk.to(F32)) * Dh ** -0.5
        s = s + _mask_bias(qpos, kpos, causal, window)[None, :, None, :]
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        o = torch.einsum("bqhk,bkhd->bqhd", p.to(v.dtype).to(F32), vv.to(F32))
        return o, m, p.sum(dim=-1)


def _all_reduce(x, op: str, group):
    """``x`` reduced by ``op`` ("sum", "max") over ``group``: the functional
    collective, which the cost model counts."""
    return torch.ops._c10d_functional.wait_tensor(
        torch.ops._c10d_functional.all_reduce(x, op, group.group_name))


def _on_rank_slots(q, k, v, qpos, kpos, causal: bool, window: int, ctx: ShardCtx):
    """A decode step's attention where the query heads do not divide over
    'tp', as the reference lays it out: the K/V caches stay on their
    capacity shards over 'tp' (``cache_leaf_spec``; a capacity that does
    not divide stays whole, and each rank takes its chunk of it), and each
    rank runs every head of its one-token query against its own slots,
    masked by their global positions (``_partial_attention``).  The f32
    partials combine over 'tp' as a split-KV softmax: the row max
    all-reduced, each rank's sums rescaled to it and all-reduced, then o /
    l.  A rank whose slots are all masked adds exp(NEG_INF - M) = 0.  A
    decode step has no backward, and the reductions have none."""
    cap = k.shape[1]
    bshd, kv = ("dp", None, None, None), ("dp", "tp", None, None)
    split = ctx.tp_axis in ctx.spec(kv, tuple(k.shape))
    group = ctx.mesh.get_group(ctx.tp_axis)

    def run(ql, kl, vl):
        lo, n = ctx.span(ctx.tp_axis, cap)
        if not split:
            kl, vl = kl[:, lo:lo + n], vl[:, lo:lo + n]
        o, m, l = _partial_attention(ql, kl, vl, qpos, kpos[lo:lo + n], causal, window)
        big = _all_reduce(m, "max", group)
        scale = torch.exp(m - big)
        l = _all_reduce(l * scale, "sum", group)
        o = _all_reduce(o * scale[..., None], "sum", group)
        return (o / l[..., None]).to(ql.dtype)

    return ctx.local_call(run, (q, k, v), (bshd, kv, kv), [(bshd, tuple(q.shape))])


def _kv_span(first: int, n: int, rep: int) -> Tuple[int, int]:
    """The KV heads [lo, hi) that query heads [first, first + n) read at
    ``rep`` query heads a KV head, such that the kernel's own mapping (local
    query head j reads local KV head j // (n // (hi - lo))) holds on the
    slice: a rank's heads must cover whole KV groups or sit inside one."""
    if n % rep and rep % n:
        raise ValueError(f"{n} query heads a rank at {rep} a KV head straddle "
                         "KV heads")
    lo = first // rep
    return lo, (first + n - 1) // rep + 1


def _on_rank_heads(fn, q, k, v, ctx: ShardCtx):
    """``fn(q, k, v, first)``, attention on plain tensors whose query row i
    is the whole query's row ``first + i``, or on each rank's local shards
    of DTensors, in the reference's layouts: the batch stays sharded over
    'dp', and the query heads over 'tp' when they divide; when they do
    not, the query stays split on the sequence over 'tp' (its rows are
    ``first`` onwards, by DTensor's own chunking; one row does not divide
    and stays whole, but ``attention_core`` sends such a decode step to
    ``_on_rank_slots``).  K and V are gathered over 'tp', a decode step's
    caches too (sharded on their capacity; where the heads divide the
    reference gathers them as well); with split heads each rank slices the
    KV heads its query heads read (``_kv_span``; MQA keeps KV head 0 on
    every rank).  Either split makes the local K/V grads partial sums over
    'tp'.  Per-rank code also keeps clear of the flatten of two sharded
    dims in a batched matmul, which torch 2.11's DTensor refuses."""
    S, H, Hkv = q.shape[1], q.shape[2], k.shape[2]
    tp = max(1, ctx.tp)
    bshd = ("dp", None, "tp", None) if H % tp == 0 else ("dp", "tp", None, None)
    kv = ("dp", None, None, None)

    def run(ql, kl, vl):
        n, rows = ql.shape[2], ql.shape[1]
        if n != H:                          # this rank's H / tp query heads
            lo, hi = _kv_span(ctx.mesh.get_local_rank(ctx.tp_axis) * n, n, H // Hkv)
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        first = 0
        if rows != S:                       # this rank's rows of the sequence
            first = ctx.mesh.get_local_rank(ctx.tp_axis) * -(-S // tp)
        return fn(ql, kl, vl, first)

    # a dim that does not divide over 'tp' stays whole (``ShardCtx.spec``)
    split = ((ctx.tp_axis,) if tp > 1 and ctx.tp_axis in ctx.spec(bshd, tuple(q.shape))
             else ())
    return ctx.local_call(run, (q, k, v), (bshd, kv, kv), [(bshd, tuple(q.shape))],
                          grad_partial=((), split, split))


def _flash(q, k, v, *, causal: bool, window: int, ctx: ShardCtx):
    """The flash-attention kernel, on each rank's heads or rows under a
    mesh; a rank's rows of a masked call start at position ``Skv - S +
    first`` (the whole query keeps the kernel's default, aligned ends)."""
    S, Skv = q.shape[1], k.shape[1]

    def kernel(q, k, v, first):
        kw = {}
        if q.shape[1] != S and (causal or window):
            kw["q_offset"] = Skv - S + first
        with span("attn_scores"):
            return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, window=window, **kw)

    return _on_rank_heads(kernel, q, k, v, ctx)


def attention_block(p, x, *, cfg, positions, causal=True, window=0,
                    kv_override: Optional[Tuple] = None, use_rope: bool = True,
                    full_kv: bool = False, chunk=1024, use_kernel: bool = True,
                    ctx: ShardCtx = ShardCtx()):
    """Projections + RoPE + attention + output proj.  x: [B, S, D].

    With ``use_kernel`` and S > 1 the flash-attention kernel runs two
    cases: full-sequence self-attention (no ``kv_override``, positions
    0..S-1), and attention over a ``kv_override`` whose every key is valid
    (``full_kv``: the caller's word, so the key positions are never read
    back from the device) with no causal or window mask, which is
    cross-attention over a whole encoder output.  Everything else, and
    everything when training passes ``use_kernel=False`` or the context
    turns the kernel off (``ctx.flash``: the dry run), runs the direct or
    chunked ``attention_core``.
    """
    B, S, D = x.shape
    H, Hkv, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    x = gather_inner(x)             # read by the q, k and v projections
    head_sharded_q = (H % max(1, ctx.tp) == 0) and S > 1
    q_layout = ("dp", None, "tp", None) if head_sharded_q else ("dp", "tp", None, None)
    # reshard before RoPE, so the boundary moves bf16 (RoPE upcasts to f32)
    q = ctx.cstr(reshape(mm(x, p["wq"]), B, S, H, Dh), *q_layout)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
    if kv_override is None:
        k = ctx.cstr(reshape(mm(x, p["wk"]), B, S, Hkv, Dh), "dp", None, None, None)
        v = ctx.cstr(reshape(mm(x, p["wv"]), B, S, Hkv, Dh), "dp", None, None, None)
        if use_rope:
            k = rope(k, positions, cfg.rope_theta)
        kpos = positions
    else:
        k, v, kpos = kv_override
    unmasked_full = kv_override is not None and full_kv and not causal and not window
    if use_kernel and ctx.flash and S > 1 and (kv_override is None or unmasked_full):
        o = _flash(q, k, v, causal=causal, window=window, ctx=ctx)
    else:
        o = attention_core(q, k, v, positions, kpos, causal=causal,
                           window=window, chunk=chunk, ctx=ctx)
    return mm(reshape(o, B, S, H * Dh), p["wo"]), (k, v)


# ------------------------------------------------------------------- MLP
def mlp_init(gen, d_model: int, d_ff: int, lead=()):
    return {
        "w_gate": dense_init(gen, (d_model, d_ff), lead=lead),
        "w_up": dense_init(gen, (d_model, d_ff), lead=lead),
        "w_down": dense_init(gen, (d_ff, d_model), lead=lead),
    }


def mlp(p, x, ctx: ShardCtx = ShardCtx()):
    """SwiGLU.  Under a mesh the input is laid out batch over 'dp' and
    whole on every other dim before the column-parallel gate and up
    products, so that each rank computes its own F / tp columns: it can
    arrive split on D or as partial sums over 'tp', and DTensor would then
    gather the weights' F instead."""
    x = gather_inner(x)             # read by the gate and up projections
    if is_dtensor(x):
        want = ctx.placements(ctx.spec(("dp",) + (None,) * (x.ndim - 1), tuple(x.shape)))
        if tuple(x.placements) != want:
            x = x.redistribute(x.device_mesh, want)
    g = mm(x, p["w_gate"])
    u = mm(x, p["w_up"])
    h = F.silu(g.to(F32)).to(x.dtype) * u
    h = ctx.cstr(h, "dp", None, "tp")
    return mm(h, p["w_down"])


# ------------------------------------------------------------- embeddings
def embed_init(gen, vocab: int, d_model: int):
    return {"embed": dense_init(gen, (vocab, d_model), in_axis=1)}


def embed_lookup(p, tokens):
    """Rows of the table.  Batch-sharded DTensor ids are gathered first:
    every rank looks up the whole batch (its layout constraint then keeps
    its own rows), since torch 2.11's DTensor cannot propagate the
    lookup's backward (``index_put``) over sharded ids."""
    return p["embed"][unshard_dim(tokens, 0)]


def logits_head(p, x, vocab_size: int):
    """LM head with padded-vocab masking."""
    logits = mm(x, p["lm_head"]).to(F32)
    pad = logits.shape[-1] - vocab_size
    if pad > 0:
        mask = torch.arange(logits.shape[-1], device=logits.device) < vocab_size
        logits = torch.where(mask, logits,
                             torch.full((), NEG_INF, dtype=F32, device=logits.device))
    return logits


# ------------------------------------------------------------------- loss
def softmax_xent(logits, labels, vocab_size: int):
    """Mean token cross entropy; labels: integer, logits' leading shape."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.mean(logz - gold)


def _xent_sum(lm_head, h, labels, vocab_size: int):
    # the pick below reads each label's logit: it needs the vocab dim whole
    logits = unshard_dim(logits_head({"lm_head": lm_head}, h, vocab_size), -1)
    logz = torch.logsumexp(logits, dim=-1)
    return torch.sum(logz - gather_last(logits, labels))


def chunked_lm_loss(params, h, labels, vocab_size: int, *, chunk: int = 256,
                    ctx=None):
    """Next-token xent without materializing full [B, S, V] logits.

    Sequence chunks of ``chunk`` positions, each chunk's logits -> xent ->
    summed; under grad mode a chunk's body is recomputed in backward (the
    reference's ``jax.checkpoint``), so no chunk's logits are kept for it.
    The last S % chunk positions run as one more, plain, chunk.
    h: [B, S, D] (positions predicting labels [B, S]).
    """
    B, S, _ = h.shape
    chunk = min(chunk, S)
    n, rem = divmod(S, chunk)
    acc = torch.zeros((), dtype=F32, device=h.device)
    for i in range(n):
        args = (params["lm_head"], h[:, i * chunk:(i + 1) * chunk],
                labels[:, i * chunk:(i + 1) * chunk], vocab_size)
        acc = acc + (checkpoint(_xent_sum, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _xent_sum(*args))
    if rem:
        acc = acc + _xent_sum(params["lm_head"], h[:, n * chunk:],
                              labels[:, n * chunk:], vocab_size)
    return acc / (B * S)
