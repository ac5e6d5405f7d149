"""The plain reference against the port on the CPU at reduced widths, on
the same weight tree, both taken from the cell's architecture module: a
prefill and decode steps through the caches, and a train step's loss and
gradients."""

import pytest
import torch

from portbench import weights as wmod
from portbench.reference import train as rtrain
from pb_helpers import reduced_cell

SERVE = ["internlm2-1.8b.doc-reuse", "olmoe-1b-7b.doc-reuse"]


def _port(cfg):
    from portbench.drivers.serve import arch_config
    return arch_config(cfg)


@pytest.mark.parametrize("name", SERVE)
def test_prefill_then_decode_equals_reference(name):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import cache_init, make_decode_step, make_prefill_step
    from repro_torch.runtime.serve_loop import _merge_prefill_caches

    cell = reduced_cell(name)
    ref, arch = cell.reference, cell.config["arch"]
    cfg = _port(cell.config)
    W = ref.make_weights(arch, 11, "cpu")
    g = torch.Generator().manual_seed(3)
    S, steps, cap = 40, 4, 64
    toks = torch.randint(0, arch["vocab_size"], (S + steps,), generator=g)
    prefill = make_prefill_step(cfg, ShapeConfig("t", "prefill", cap, 1))
    decode = make_decode_step(cfg)
    _, pre = prefill(W, {"tokens": toks[None, :S]})
    caches = _merge_prefill_caches(cache_init(cfg, 1, cap, device="cpu"), pre, cfg)
    got = []
    for i in range(steps):
        lg, caches = decode(W, {"token": toks[S + i:S + i + 1], "pos": S + i,
                                "caches": caches})
        got.append(lg[0, :arch["vocab_size"]].float())
    want = ref.forward_logits(W, arch, toks, list(range(S, S + steps)),
                              segments=[S] + [1] * steps)
    got = torch.stack(got)
    err = ((got - want).abs().max(-1).values / want.std(-1)).max()
    assert err < 0.1, float(err)            # bf16 activations against float32
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_fp8_control_is_farther_than_the_port():
    cell = reduced_cell(SERVE[0])
    ref, arch = cell.reference, cell.config["arch"]
    W = ref.make_weights(arch, 12, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (48,), generator=torch.Generator().manual_seed(4))
    pos = list(range(40, 48))
    f32 = ref.forward_logits(W, arch, toks, pos)
    fp8 = ref.forward_logits(W, arch, toks, pos, precision="fp8")
    assert ((fp8 - f32).abs().max() / f32.std()) > 0.1


def test_train_loss_and_grads_equal_reference():
    from repro_torch.models import make_loss_fn
    from repro_torch.configs.base import ShapeConfig

    cell = reduced_cell("internlm2-1.8b.train")
    ref, arch = cell.reference, cell.config["arch"]
    cfg = _port(cell.config)
    W = ref.make_weights(arch, 13, "cpu")
    toks = torch.randint(0, arch["vocab_size"], (2, 32), generator=torch.Generator().manual_seed(5))
    paths = [p for p, _ in wmod.leaves(W)]
    leaves = {p: x.detach().clone().requires_grad_(True) for p, x in wmod.leaves(W)}
    tree = rtrain._unflatten(W, leaves)
    loss, _ = make_loss_fn(cfg, ShapeConfig("t", "train", 32, 2))(tree, {"tokens": toks})
    grads = torch.autograd.grad(loss, [leaves[p] for p in paths])
    fl = {p: x.detach().float().requires_grad_(True) for p, x in wmod.leaves(W)}
    want = ref.train_loss(rtrain._unflatten(W, fl), arch, toks)
    wgrads = torch.autograd.grad(want, [fl[p] for p in paths])
    loss, want = float(loss.detach()), float(want.detach())
    assert abs(loss - want) < 1e-2 * want
    for p, a, b in zip(paths, grads, wgrads):
        rel = float(torch.linalg.vector_norm(a.float() - b) / torch.linalg.vector_norm(b))
        assert rel < 0.05, (p, rel)
