"""RWKV-6 "Finch" blocks on torch: data-dependent-decay WKV recurrence
(arXiv:2404.05892).

A port of the reference's ``models/rwkv.py``.  Time-mix: token shift with
dynamic (LoRA) interpolation for r/k/v/w/g, the WKV linear-attention state
S_t = diag(w_t) S_{t-1} + k_t^T v_t with bonus u, a per-head norm and a silu
gate.  Channel-mix: token shift + squared-ReLU FFN with a receptance gate.

Serving (``timemix_apply(train=False)``) runs the recurrence in the WKV6
kernel (``kernels.wkv6``) for every T: the reference picks its chunked scan
for a prompt and the plain scan for one token, and both are the exact
recurrence, which is what the kernel computes.  The kernel has no
backward, so training takes the reference's own route: ``wkv_chunked``
for T > 1 (each chunk recomputed in backward, as the reference's
``jax.checkpoint`` of its chunk body does) and ``wkv_scan`` for T = 1,
Python loops over time that autograd differentiates on the CPU and on the
card alike; both loops are marked (``trips.scan``), so the cost model
counts them by their trip counts.  Under a mesh the kernel, and the train
route's loops, run on each rank's local batch and head shard (heads over
'tp' where they divide), the split the reference's compiled step makes of
the recurrence.
The recurrence, the loop's steps or the kernel's call, runs in the
``record_function`` region "wkv_scan" (the reference's named scope; the
cost model reads it), opened through ``obs.spans.span``.  Dtypes
follow the reference: ``mu``, ``mix_b`` and ``wo`` bf16; ``w0``,
``decay_b`` and ``u`` fp32.
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .. import trips
from ..kernels.rwkv6_scan.ops import wkv6
from ..obs.spans import span
from .layers import BF16, F32, dense_init, rmsnorm, rmsnorm_init
from .sharding import ShardCtx, is_dtensor, mm, reshape

LORA_MIX = 32
LORA_DECAY = 64


def timemix_init(gen, d_model: int, head_dim: int, lead=()):
    A = d_model  # attention dim == d_model (as in the released models)
    dev = gen.device
    lead = tuple(lead)
    return {
        "mu": torch.full(lead + (5, d_model), 0.5, dtype=BF16, device=dev),  # r,k,v,w,g
        "mix_a": dense_init(gen, (d_model, 5 * LORA_MIX), lead=lead),
        "mix_b": dense_init(gen, (5, LORA_MIX, d_model), lead=lead),
        "wr": dense_init(gen, (d_model, A), lead=lead),
        "wk": dense_init(gen, (d_model, A), lead=lead),
        "wv": dense_init(gen, (d_model, A), lead=lead),
        "wg": dense_init(gen, (d_model, A), lead=lead),
        "wo": dense_init(gen, (A, d_model), lead=lead),
        "w0": torch.full(lead + (A,), -6.0, dtype=F32, device=dev),          # decay base
        "decay_a": dense_init(gen, (d_model, LORA_DECAY), lead=lead),
        "decay_b": dense_init(gen, (LORA_DECAY, A), dtype=F32, lead=lead),
        "u": torch.full(lead + (A,), 0.5, dtype=F32, device=dev),            # bonus
        "ln_out": rmsnorm_init(A, dev, lead),
    }


def channelmix_init(gen, d_model: int, d_ff: int, lead=()):
    dev = gen.device
    lead = tuple(lead)
    return {
        "mu_k": torch.full(lead + (d_model,), 0.5, dtype=BF16, device=dev),
        "mu_r": torch.full(lead + (d_model,), 0.5, dtype=BF16, device=dev),
        "wk": dense_init(gen, (d_model, d_ff), lead=lead),
        "wv": dense_init(gen, (d_ff, d_model), lead=lead),
        "wr": dense_init(gen, (d_model, d_model), lead=lead),
    }


def _token_shift(x, prev):
    """[B, T, D] -> the previous token at each position; prev: [B, D] carry-in."""
    return torch.cat([prev[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)


# ``on`` while a checkpointed chunk of ``wkv_chunked`` is recomputed for its
# backward (the checkpoint's recompute context), in the thread running it
_recomputing = threading.local()


@contextlib.contextmanager
def _recompute():
    prev, _recomputing.on = getattr(_recomputing, "on", False), True
    try:
        yield
    finally:
        _recomputing.on = prev


class _Read(torch.autograd.Function):
    """``einsum("bhi,bhij->bhj", r, M)``, a step's read of its state.  Its
    backward reads ``r`` and ``M`` and never the product, so a chunk's
    recompute skips it (the chunk's output is not read in backward; the
    reference's compiled step drops that product from its recompute too).
    The grads are autograd's, bit for bit; M's, an outer product, is the
    broadcast multiply it is (not a product over a dim of one)."""

    @staticmethod
    def forward(ctx, r, M):
        ctx.save_for_backward(r, M)
        if getattr(_recomputing, "on", False):
            return r.new_empty(M.shape[:-2] + M.shape[-1:])
        return torch.einsum("bhi,bhij->bhj", r, M)

    @staticmethod
    def backward(ctx, g):
        r, M = ctx.saved_tensors
        return (torch.matmul(g[..., None, :], M.transpose(-1, -2))[..., 0, :],
                r[..., :, None] * g[..., None, :])


def wkv_scan(r, k, v, w, u, s0):
    """Exact WKV6 recurrence, a Python loop over time (plain version).

    r, k, v: [B, T, H, N]; w: [B, T, H, N] decay in (0, 1); u: [H, N];
    s0: [B, H, N, N].  Returns (out [B, T, H, N] f32, sT).  S[i, j]: key dim
    i, value dim j.
    """
    S = s0.to(F32)
    u4 = u[None, :, :, None]

    def step(_, S, r_t, k_t, v_t, w_t):
        kv = k_t[..., :, None] * v_t[..., None, :]                  # [B, H, N, N]
        out = _Read.apply(r_t, S + u4 * kv)
        return w_t[..., :, None] * S + kv, out

    with span("wkv_scan"):           # region of the cost model
        # one unbind a tensor: in backward its step grads are stacked once
        # (indexing step by step would add T full-size grads)
        S, out = trips.scan(r.shape[1], step, S, [a.to(F32) for a in (r, k, v, w)])
        return out, S


def wkv_chunked(r, k, v, w, u, s0, chunk: int = 128):
    """WKV6 as an outer loop over time chunks of the exact scan: the
    reference's prompt path, numerically the same as ``wkv_scan``.  Under
    grad mode each chunk is recomputed in backward, so only the
    chunk-boundary states are kept; the recompute skips the steps' reads
    (``_Read``).  Every operand, ``u`` included, goes to the checkpointed
    call as an argument: the reentrant form would drop the grads of a
    tensor the chunk only closes over."""
    B, T, H, N = r.shape
    chunk = min(chunk, T)
    assert T % chunk == 0, (T, chunk)

    def step(i, S):
        xs = tuple(a[:, i * chunk:(i + 1) * chunk] for a in (r, k, v, w))
        if torch.is_grad_enabled():
            out, S = checkpoint(wkv_scan, *xs, u, S, use_reentrant=False,
                                context_fn=lambda: (contextlib.nullcontext(), _recompute()))
        else:
            out, S = wkv_scan(*xs, u, S)
        return S, out

    S, out = trips.scan(T // chunk, step, s0.to(F32), join="cat")
    return out, S


def _wkv6_kernel(*operands):
    with span("wkv_scan"):
        return wkv6(*operands)


def _lora_mix(dyn, mix_b, ctx: ShardCtx):
    """``einsum("btzl,zld->btzd", dyn, mix_b)``, the dynamic mix's second
    LoRA product, under a mesh as the reference's compiled step splits it,
    one product a rank (no flatten of two sharded dims, which torch 2.11's
    DTensor refuses).  A prompt or a train step (T > 1): each rank's batch
    of ``dyn`` (whole on the LoRA dim) by its width of ``mix_b`` (the LoRA
    dim gathered over 'dp'), the width then gathered into ``dyn``'s batch
    layout.  A decode step (T = 1) multiplies each rank's own block of
    ``mix_b`` as its param spec lays it out (the LoRA dim over 'dp', the
    width over 'tp', where they divide) by the same slice of the LoRA dim
    of the whole ``dyn``; the partial sums over 'dp' are reduced and the
    width gathered into ``dyn``'s batch layout, as the whole product gives
    it."""
    if not (is_dtensor(dyn) and is_dtensor(mix_b)):
        return torch.einsum("btzl,zld->btzd", dyn, mix_b)
    if dyn.shape[1] != 1:
        B, T, Z, _ = dyn.shape
        batch, width = ("dp", None, None, None), (None, None, "tp")
        split_b = ctx.spec(batch, tuple(dyn.shape))[0] is not None
        split_w = ctx.spec(width, tuple(mix_b.shape))[2] is not None
        out = ctx.local_call(
            lambda d, m: torch.einsum("btzl,zld->btzd", d, m), (dyn, mix_b),
            (batch, width), [(("dp", None, None, "tp"), (B, T, Z, mix_b.shape[2]))],
            grad_partial=((ctx.tp_axis,) if split_w else (),
                          tuple(ctx.dp_axes) if split_b else ()))
        return ctx.cstr(out, "dp", None, None, None)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = mix_b.device_mesh
    lora = [Shard(3) if p == Shard(1) else Replicate() for p in mix_b.placements]
    out = torch.einsum("btzl,zld->btzd", dyn.redistribute(mesh, lora).to_local(),
                       mix_b.to_local())
    B, T, Z, _ = dyn.shape
    shape = (B, T, Z, mix_b.shape[2])
    out = DTensor.from_local(
        out, mesh, [Partial() if p == Shard(1) else Shard(3) if p == Shard(2)
                    else Replicate() for p in mix_b.placements],
        run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())
    # the sums reduced onto the batch while the width is still split, then
    # the width gathered (DTensor would gather it first, and reduce tp
    # times the bytes)
    return ctx.cstr(ctx.cstr(out, "dp", None, None, "tp"), "dp", None, None, None)


def timemix_apply(p, x, shift_prev, s0, head_dim: int, train: bool = False,
                  ctx: ShardCtx = ShardCtx()):
    """x: [B, T, D].  Returns (out, new_shift [B, D], sT).  ``train``: the
    reference's scans instead of the kernel."""
    B, T, D = x.shape
    H = D // head_dim
    xx = _token_shift(x, shift_prev) - x
    mixed = x + xx * p["mu"][0]  # base for the dynamic mix coefficients
    dyn = _lora_mix(reshape(torch.tanh(mm(mixed, p["mix_a"])), B, T, 5, LORA_MIX),
                    p["mix_b"], ctx)
    x_r, x_k, x_v, x_w, x_g = (x + xx * (p["mu"][z] + dyn[:, :, z]) for z in range(5))

    r = ctx.cstr(reshape(mm(x_r, p["wr"]), B, T, H, head_dim), "dp", None, None, None)
    k = ctx.cstr(reshape(mm(x_k, p["wk"]), B, T, H, head_dim), "dp", None, None, None)
    v = ctx.cstr(reshape(mm(x_v, p["wv"]), B, T, H, head_dim), "dp", None, None, None)
    g = F.silu(mm(x_g, p["wg"]).to(F32))
    # the decay LoRA's partial sums reduced onto the width before the bias
    # is added: torch 2.11's DTensor cannot add a replicated bias to them
    logw = p["w0"] + ctx.cstr(
        mm(torch.tanh(mm(x_w.to(F32), p["decay_a"].to(F32))), p["decay_b"]), "dp", None, "tp")
    w = reshape(torch.exp(-torch.exp(logw)), B, T, H, head_dim)  # decay in (0, 1)
    w = ctx.cstr(w, "dp", None, None, None)
    u = reshape(p["u"], H, head_dim)

    # the kernel, or in training the reference's scans, on each rank's batch
    # and heads (heads that do not divide stay whole), so u's grad is a
    # partial sum over the batch's axes; the state comes back laid out as
    # the cache holds it, batch only
    scan = _wkv6_kernel if not train else wkv_chunked if T > 1 else wkv_scan
    bthn, bhnn = ("dp", None, "tp", None), ("dp", "tp", None, None)
    split_b = ctx.spec(bthn, (B, T, H, head_dim))[0] is not None
    out, sT = ctx.local_call(
        scan, (r, k, v, w, u, s0), (bthn,) * 4 + (("tp", None), bhnn),
        [(bthn, (B, T, H, head_dim)), (bhnn, (B, H, head_dim, head_dim))],
        grad_partial=((),) * 4 + (tuple(ctx.dp_axes) if split_b else (),))
    sT = ctx.cstr(sT, "dp", None, None, None)
    out = reshape(out, B, T, D)
    if H % max(1, ctx.tp):
        # heads that do not divide over 'tp': the cotangent, split on D, is
        # gathered before it is viewed back as [B, T, H, N]
        out = ctx.cstr(out, "dp", None, None)
    out = rmsnorm(p["ln_out"], out)
    out = mm((out.to(F32) * g).to(x.dtype), p["wo"])
    # a copy: the view would pin the whole [B, T, D] input until the caches
    # are stacked (a JAX slice is a copy)
    return out, x[:, -1, :].clone(), sT


def timemix_step(p, x1, shift_prev, s0, head_dim: int):
    """Single-token decode step.  x1: [B, D].  Returns (out, shift, S)."""
    out, shift, sT = timemix_apply(p, x1[:, None, :], shift_prev, s0, head_dim)
    return out[:, 0, :], shift, sT


def channelmix_apply(p, x, shift_prev):
    xx = _token_shift(x, shift_prev) - x
    x_k = x + xx * p["mu_k"]
    x_r = x + xx * p["mu_r"]
    k = torch.square(torch.relu(mm(x_k, p["wk"]).to(F32))).to(x.dtype)
    out = torch.sigmoid(mm(x_r, p["wr"]).to(F32)).to(x.dtype) * mm(k, p["wv"])
    return out, x[:, -1, :].clone()          # a copy, as above


def rwkv_state_init(batch: int, d_model: int, head_dim: int, device=None, lead=()):
    H = d_model // head_dim
    lead = tuple(lead)
    return {
        "S": torch.zeros(lead + (batch, H, head_dim, head_dim), dtype=F32, device=device),
        "shift_tm": torch.zeros(lead + (batch, d_model), dtype=BF16, device=device),
        "shift_cm": torch.zeros(lead + (batch, d_model), dtype=BF16, device=device),
    }
