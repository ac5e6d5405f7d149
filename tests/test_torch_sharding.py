"""The port's sharding context, sharded training and elastic checkpoints
against the reference's.

Spec rules need no process group: ``ShardCtx.spec``, ``spec_for_param``,
``tree_param_specs``, ``cache_leaf_spec``, ``batch_specs`` and
``opt_state_specs`` equal the reference's outputs over every param, cache
and batch path of each reduced arch, on size-only meshes.

The rest runs on four gloo ranks (``_torch_sharded_jobs.py``, a (2, 2)
("data", "model") mesh) beside the reference in a process of its own
with four forced host devices on an ``Auto`` mesh of the same shape
(``_sharded_reference.py``), both fed the same seeded numpy inputs and
bridged weights:

  * ``moe_ffn_sharded`` (D 32, F 64, E 8, K 2, B 4, S 16, f32): out and
    aux within 1e-5 of the reference's sharded result, without and with
    capacity drops; within 1e-5 of the port's ``moe_ffn`` when nothing
    drops;
  * the sharded loss of reduced internlm2, olmoe and rwkv6 in f32 params
    within 1e-4 of the reference's sharded loss, its grads within 1e-4
    relative L2; in bf16 the sharded loss within 2e-3 of the port's
    single-device loss (olmoe: 0.05, the reference's own bound, since its
    sharded MoE takes the capacity and the aux term from the row's
    tokens);
  * two ``Trainer`` steps of reduced internlm2 (f32 params) on (2, 2)
    against one device: losses within 1e-5, final params within 1e-5
    relative L2;
  * checkpoints: the (2, 2) save restores bit-exact on (4, 1), on one
    device, and through the reference's ``restore_checkpoint``; a
    single-device save restores bit-exact under (2, 2); a trainer under
    (4, 1) resumes from the (2, 2) save;
  * sharded serving of reduced internlm2, olmoe, recurrentgemma and rwkv6
    (``DiffusionServer(ctx=)``, every kernel on the local shards): the
    assignment log and counters equal to the reference's sharded server's,
    modeled and real payload; prefill and decode logits on f32 params
    within 1e-4 of the reference's sharded steps, and on bf16 params
    within per-arch bounds of the port's on one device; greedy tokens on
    f32 params equal to one device's; olmoe's decode steps running K4 on
    each rank's [E / tp, C / dp] block, no expert gathered over 'model';
    K3's KV heads per rank at tp = 2;
  * query heads that do not divide over 'tp' (reduced gemma3-1b with 3
    heads, its sliding window along): the f32 loss and grads, prefill and
    decode logits and the server against the reference's sharded runs,
    each rank attending its own S / tp query rows (K3 at its offset in
    prefill, the plain route in training), and in decode its own cap / tp
    cache slots (a split-KV softmax);
  * ``port_checks``, what ``chip_smoke.py``'s ``gloo4`` phase holds these
    runs to without the reference, all passing.

The launcher runs in process at world size 1 on gloo (``--mesh host``);
``torchrun --master-port 0`` is refused at once.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.checkpoint import restore_checkpoint as jax_restore_checkpoint
from repro.configs import get_arch as jax_get_arch
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.launch import shardings as jsh
from repro.models import sharding as jsd
from repro_torch.configs import ALL_ARCHS, get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import shardings as tsh
from repro_torch.models import init_opt_state, init_params
from repro_torch.models import lm as tlm
from repro_torch.models import sharding as tsd
from repro_torch.models.api import cache_init, is_encdec
from repro_torch.optim.adamw import adamw8bit_init
from repro_torch.tree import tree_flatten_with_paths, tree_map

from _torch_sharded_jobs import (ARCHS, BF16_LOGITS_TOL, BF16_TIE, PREFILL_ARCHS,
                                 SERVE_ARCHS, SPLIT_ARCH, expert_block_problems,
                                 make_inputs, port_checks, reduced_cfg, run_ranks,
                                 split_rows_problems)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
LOSS_ARCHS = ARCHS + (SPLIT_ARCH,)


class FakeMesh:
    def __init__(self, shape):
        self.shape = shape


MESHES = {"16x16": {"data": 16, "model": 16}, "2x2": {"data": 2, "model": 2},
          "pod2x16x16": {"pod": 2, "data": 16, "model": 16}}


def _ctxs(mesh_name):
    sizes = MESHES[mesh_name]
    dp = ("pod", "data") if "pod" in sizes else ("data",)
    return (tsd.ShardCtx(mesh=FakeMesh(sizes), dp_axes=dp),
            jsd.ShardCtx(mesh=FakeMesh(sizes), dp_axes=dp))


def _jax_shapes(tree):
    """The port's tree as the reference's ShapeDtypeStruct pytree."""
    return tree_map(lambda t: jax.ShapeDtypeStruct(tuple(t.shape), np.float32), tree)


def _ref_leaves(specs):
    return [tuple(s) for s in jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, JP))]


def _port_leaves(specs):
    return [tuple(s) for s in tsd.spec_leaves(specs)]


# ------------------------------------------------------------------ spec rules
def test_spec_rules_paths():
    ctx = tsd.ShardCtx(mesh=FakeMesh({"data": 16, "model": 16}))
    P = tsd.P
    assert tsd.spec_for_param(ctx, "groups/b0/attn/wq", (4096, 4096)) == P("data", "model")
    assert tsd.spec_for_param(ctx, "groups/b0/attn/wo", (4096, 4096)) == P("model", "data")
    assert tsd.spec_for_param(ctx, "groups/b0/ffn/w_down", (14336, 4096)) == P("model", "data")
    assert tsd.spec_for_param(ctx, "embed", (128512, 4096)) == P("model", "data")
    assert tsd.spec_for_param(ctx, "groups/b0/moe/experts/w1",
                              (128, 4096, 1536)) == P("model", "data", None)
    assert tsd.spec_for_param(ctx, "groups/b0/moe/experts/w2",
                              (128, 1536, 4096)) == P("model", None, "data")
    assert tsd.spec_for_param(ctx, "x/wq", (100, 100)) == P(None, None)
    assert tsd.spec_for_param(ctx, "norm1/scale", (4096,)) == P(None)


def test_guard_replicates_indivisible():
    ctx = tsd.ShardCtx(mesh=FakeMesh({"data": 16, "model": 16}))
    P = tsd.P
    assert ctx.spec(["dp", None], (1, 5)) == P(None, None)
    assert ctx.spec(["dp", "tp"], (32, 48)) == P("data", "model")
    assert ctx.spec([None, "tp"], (8, 40)) == P(None, None)
    assert ctx.spec(["dptp"], (512,)) == P(("data", "model"))
    assert ctx.spec(["dptp"], (128,)) == P(None)
    with pytest.raises(ValueError):
        ctx.spec(["xx"], (4,))


def test_no_mesh_context_is_a_no_op():
    ctx = tsd.ShardCtx()
    x = torch.ones(3, 4)
    assert ctx.dp == ctx.tp == 1
    assert ctx.spec(["dp", "tp"], (4, 4)) == tsd.P(None, None)
    assert ctx.cstr(x, "dp", "tp") is x and ctx.named(tsd.P(None)) is None
    assert tsd.tree_shardings(ctx, {"a": x, "b": [x]}) == {"a": None, "b": [None]}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_logical_specs_equal_references(mesh_name):
    tctx, jctx = _ctxs(mesh_name)
    for logical in (["dp", None], ["dp", "tp"], [None, "tp"], ["dptp", None],
                    ["tp", "dp", None], ["dp", None, "tp"]):
        for shape in ((1, 5, 7), (32, 48, 64), (512, 40, 16), (4, 256, 1024)):
            shape = shape[:len(logical)]
            assert tuple(tctx.spec(logical, shape)) == tuple(jctx.spec(logical, shape))


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_param_and_opt_specs_equal_references(arch, mesh_name):
    tctx, jctx = _ctxs(mesh_name)
    cfg = get_arch(arch).reduced()
    params = init_params(cfg, device="cpu", seed=0)
    jparams = _jax_shapes(params)
    assert _port_leaves(tsd.tree_param_specs(tctx, params)) == \
        _ref_leaves(jsd.tree_param_specs(jctx, jparams))
    for opt in (init_opt_state(params), adamw8bit_init(params)):
        t = tsh.opt_state_specs(tctx, params, opt)
        j = jsh.opt_state_specs(jctx, jparams, {k: (_jax_shapes(v) if k != "step" else v)
                                                for k, v in opt.items()})
        assert sorted(t) == sorted(j)
        for k in t:
            assert _port_leaves(t[k]) == _ref_leaves(j[k]), k


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_cache_and_batch_specs_equal_references(arch, mesh_name):
    tctx, jctx = _ctxs(mesh_name)
    cfg = get_arch(arch).reduced()
    B, S = 32, 64
    caches = cache_init(cfg, B, S, device="cpu")
    paths, leaves, _ = tree_flatten_with_paths(caches)
    for p, x in zip(paths, leaves):
        assert tuple(tsh.cache_leaf_spec(tctx, p, tuple(x.shape))) == \
            tuple(jsh.cache_leaf_spec(jctx, p, tuple(x.shape))), p
    z = lambda *s: torch.zeros(s)
    if is_encdec(cfg):
        train = {"audio_embeds": z(B, S, cfg.d_model), "tokens": z(B, 16)}
    else:
        train = {"tokens": z(B, S)}
        if cfg.frontend == "vision":
            train["patch_embeds"] = z(B, 8, cfg.d_model)
    decode = {"token": z(B), "pos": z(), "caches": caches}
    for batch in (train, decode, {"tokens": z(1, S)}):
        shape = ShapeConfig("t", "train", S, B)
        jshape = JaxShapeConfig("t", "train", S, B)
        assert _port_leaves(tsh.batch_specs(tctx, cfg, shape, batch)) == \
            _ref_leaves(jsh.batch_specs(jctx, jax_get_arch(arch).reduced(), jshape,
                                        _jax_shapes(batch)))


def test_step_out_specs_equal_references():
    tctx, jctx = _ctxs("2x2")
    cfg = get_arch("internlm2-1.8b").reduced()
    params = init_params(cfg, device="cpu", seed=0)
    opt = init_opt_state(params)
    metrics = {"loss": torch.zeros(()), "grad_norm": torch.zeros(())}
    jopt = {k: (_jax_shapes(v) if k != "step" else v) for k, v in opt.items()}
    t = tsh.step_out_specs(tctx, "train", (params, opt, metrics))
    j = jsh.step_out_specs(jctx, "train", (_jax_shapes(params), jopt,
                                           _jax_shapes(metrics)))
    assert _port_leaves(t) == _ref_leaves(j)
    caches = cache_init(cfg, 4, 16, device="cpu")
    logits = torch.zeros(4, cfg.padded_vocab)
    t = tsh.step_out_specs(tctx, "decode", (logits, caches))
    j = jsh.step_out_specs(jctx, "decode", (_jax_shapes(logits), _jax_shapes(caches)))
    assert _port_leaves(t) == _ref_leaves(j)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 2)

    ctx = tsd.ShardCtx(mesh=Mesh())
    P = tsd.P
    assert ctx.placements(P("data", None)) == (Shard(0), Replicate())
    assert ctx.placements(P("model", "data")) == (Shard(1), Shard(0))
    assert ctx.placements(P(None, ("data", "model"))) == (Shard(1), Shard(1))
    assert ctx.placements(P()) == (Replicate(), Replicate())

    class Mesh41(Mesh):
        shape = (4, 1)

    ctx = tsd.ShardCtx(mesh=Mesh41())
    assert ctx.placements(P("model", "data")) == (Shard(1), Replicate())
    # the step outputs' shardings: one NamedSharding a leaf, None without a mesh
    params = {"w": torch.zeros(8, 4), "b": [torch.zeros(4)]}
    opt = {"m": params, "v": params, "step": torch.zeros(())}
    train = (params, opt, {"loss": torch.zeros(())})
    out = tsh.step_out_shardings(ctx, "train", train)
    assert out[0]["w"].placements == (Shard(0), Replicate())
    assert out[1]["step"].placements == (Replicate(), Replicate())
    assert out[2]["loss"].mesh is ctx.mesh
    assert tsh.step_out_shardings(tsd.ShardCtx(), "train", train)[0]["b"] == [None]


# ------------------------------------------------------------ multi-rank runs
def _inputs(path):
    make_inputs(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded")
    _inputs(tmp / "inputs.npz")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    ref_log = open(tmp / "reference.log", "w")
    ref = subprocess.Popen([sys.executable, str(TESTS / "_sharded_reference.py"),
                            str(tmp / "inputs.npz"), str(tmp / "reference.npz")],
                           stdout=ref_log, stderr=subprocess.STDOUT, env=env)
    try:
        run_ranks(tmp, "sharding", inputs=tmp / "inputs.npz",
                  extra=[("reference", ref)])
    except BaseException:
        print((tmp / "reference.log").read_text()[-3000:])
        raise
    return {"port": dict(np.load(tmp / "result.npz")),
            "ref": dict(np.load(tmp / "reference.npz")),
            "flags": json.loads((tmp / "flags.json").read_text())}


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("case", ["nodrop", "drop"])
def test_moe_ffn_sharded_matches_reference(runs, case):
    t, j = runs["port"], runs["ref"]
    assert np.abs(t[f"moe/{case}/out"] - j[f"moe/{case}/out"]).max() < 1e-5
    assert abs(float(t[f"moe/{case}/aux"]) - float(j[f"moe/{case}/aux"])) < 1e-5


def test_moe_ffn_sharded_drops_where_the_reference_does(runs):
    t = runs["port"]
    assert np.abs(t["moe/drop/out"] - t["moe/nodrop/out"]).max() > 1e-3


def test_moe_on_a_mesh_that_cannot_split_the_tokens_is_the_global_math(runs):
    """S = 3 on a model axis of 2: ``_ffn_apply`` takes ``moe_ffn`` on
    DTensors; in training (replicated operands) out, aux and the input grad
    equal one device's, and in serving (each rank's block of the capacity
    buffer, summed over the mesh) out and aux do."""
    assert float(runs["port"]["moe/replicated/err"]) < 1e-6


def test_moe_ffn_sharded_matches_dense_when_nothing_drops(runs):
    t = runs["port"]
    assert np.abs(t["moe/nodrop/out"] - t["moe/dense/out"]).max() < 1e-5


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_loss_matches_reference_f32(runs, arch):
    t, j = runs["port"], runs["ref"]
    assert abs(float(t[f"loss/{arch}"]) - float(j[f"loss/{arch}"])) < 1e-4
    assert abs(float(t[f"aux/{arch}"]) - float(j[f"aux/{arch}"])) < 1e-4


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_grads_match_reference_f32(runs, arch):
    """Every leaf within 1e-4 relative L2 of the reference's sharded grad,
    but the embedding: both models cast its rows to bf16, so its grad is a
    bf16 cotangent whose roundings flip on any last-bit difference of the
    f32 sums behind it.  It is held within 1e-4 of the port's own
    single-device grad, and within 5e-4 of the reference's, which the
    single-device port is itself 1.2e-4 to 1.9e-4 from."""
    t, j = runs["port"], runs["ref"]
    keys = sorted(k for k in j if k.startswith(f"grads/{arch}/"))
    assert keys and keys == sorted(k for k in t if k.startswith(f"grads/{arch}/"))
    emb = f"grads/{arch}/embed"
    worst = max((_rel_l2(t[k], j[k]), k) for k in keys if k != emb)
    assert worst[0] < 1e-4, worst
    assert _rel_l2(t[emb], j[emb]) < 5e-4
    if arch != "olmoe-1b-7b":         # its sharded MoE is other math than one device's
        assert _rel_l2(t[emb], t["grads1" + emb[len("grads"):]]) < 1e-4


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_sharded_loss_matches_single_device_bf16(runs, arch):
    t = runs["port"]
    tol = 0.05 if arch == "olmoe-1b-7b" else 2e-3
    assert abs(float(t[f"bf16/sharded/{arch}"]) - float(t[f"bf16/single/{arch}"])) < tol


def test_sharded_trainer_matches_single_device(runs):
    t = runs["port"]
    assert len(t["trainer/sharded/losses"]) == 2
    assert np.abs(t["trainer/sharded/losses"] - t["trainer/single/losses"]).max() < 1e-5
    keys = [k for k in t if k.startswith("trainer/single/params/")]
    assert keys
    worst = max(_rel_l2(t[k.replace("/single/", "/sharded/")], t[k]) for k in keys)
    assert worst < 1e-5, worst


def test_sharded_step_with_microbatches_matches_single_device(runs):
    """Two microbatches: the batch sliced along its 'data'-sharded dim,
    the f32 accumulator in each param's layout."""
    t = runs["port"]
    assert abs(float(t["mb2/sharded/loss"]) - float(t["mb2/single/loss"])) < 1e-5
    keys = [k for k in t if k.startswith("mb2/single/params/")]
    assert keys
    worst = max(_rel_l2(t[k.replace("/single/", "/sharded/")], t[k]) for k in keys)
    assert worst < 1e-5, worst


@pytest.mark.parametrize("flag", ["restore_22_on_41_exact", "restore_1_on_22_exact",
                                  "resume_41_exact"])
def test_checkpoints_cross_mesh_shapes_bit_exact(runs, flag):
    assert runs["flags"][flag] is True


def test_elastic_restore_lands_on_the_new_mesh(runs):
    f = runs["flags"]
    assert f["resume_41_step"] == 2
    # wq [groups, D, H * Dh] = [4, 64, 64]: D over the 4 'data' ranks, and
    # replicated on the 'model' axis of one rank
    mesh, placements, local, whole = f["restore_22_on_41_wq"]
    assert mesh == [4, 1] and whole == [4, 64, 64] and local == [4, 16, 64]
    assert placements == "(Shard(dim=1), Replicate())"


def test_reference_reads_the_sharded_save_bit_exact(runs):
    """The reference's ``restore_checkpoint`` reads the (2, 2) save and
    gets the bits the port's one-device restore got."""
    d = runs["flags"]["ckpt_dir_22"]
    t = runs["port"]
    like = init_params(get_arch("internlm2-1.8b").reduced(), device="cpu", seed=0)
    target = {"params": tree_map(lambda x: np.zeros(tuple(x.shape), np.float32), like)}
    got = jax_restore_checkpoint(d, 2, target)
    flat = jax.tree_util.tree_flatten_with_path(got["params"])[0]
    assert flat
    for kp, x in flat:
        path = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)
        mine = t[f"trainer/sharded/params/{path}"]
        assert np.asarray(x).dtype == np.float32
        assert np.array_equal(np.asarray(x).view(np.uint32), mine.view(np.uint32)), path


def test_kernel_guard_refuses_dtensors(runs):
    assert runs["flags"]["guard_raises"] is True
    assert runs["flags"]["guard_passes_plain"] is True


def test_mesh_builders(runs):
    f = runs["flags"]
    assert "needs a process group of 256 ranks" in f["production_refused"]
    assert "has 4" in f["production_refused"]
    assert f["host_mesh"] == [["data", "model"], [2, 2]]


# ------------------------------------------------------------------- launcher
def _launch(argv, capsys):
    from repro_torch.launch import train

    train.main(argv)
    out = capsys.readouterr().out.splitlines()
    report = json.loads(next(l for l in out if l.startswith("train: "))[len("train: "):])
    return out, report


@pytest.mark.parametrize("arch,tol", [("internlm2-1.8b", 2e-3), ("olmoe-1b-7b", 2e-3)])
def test_launcher_mesh_host_matches_mesh_none(arch, tol, tmp_path, capsys, monkeypatch):
    import torch.distributed as dist

    calls = []
    real = tlm.moe_ffn_sharded

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tlm, "moe_ffn_sharded", counting)
    base = ["--arch", arch, "--reduced", "--steps", "2", "--device", "cpu"]
    out_h, rep_h = _launch(base + ["--mesh", "host", "--ckpt-dir", str(tmp_path / "h")],
                           capsys)
    assert not dist.is_initialized()          # the launcher ended the group it started
    n_sharded = len(calls)
    out_n, rep_n = _launch(base + ["--ckpt-dir", str(tmp_path / "n")], capsys)
    assert len(calls) == n_sharded
    assert rep_h["mesh"] == [1, 1] and rep_n["mesh"] == [1, 1]
    assert len(rep_h["losses"]) == 2
    assert np.abs(np.array(rep_h["losses"]) - np.array(rep_n["losses"])).max() < tol
    for out in (out_h, out_n):
        assert [l.split()[0] for l in out] == ["step", "step", "train:", "done:"]
        assert out[-1].startswith("done: 2 steps, final loss ")
    cfg = get_arch(arch).reduced()
    # every MoE layer, forward and its recompute in backward, each step
    assert n_sharded == (2 * 2 * cfg.num_layers if cfg.num_experts else 0)


# ------------------------------------------------------------- sharded serving
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_server_matches_reference(runs, arch):
    """Assignment log and counters of the port's server on the (2, 2) mesh,
    modeled and real payload, equal the reference's sharded server's."""
    ref = json.loads(str(runs["ref"][f"serve/{arch}/stream"]))
    port = runs["flags"][f"serve/{arch}"]
    assert ref["counters"]["swap_ins"] >= 1 and len(ref["log"]) == 6
    for payload in ("modeled", "real"):
        assert port[payload]["log"] == ref["log"], payload
        assert port[payload]["counters"] == ref["counters"], payload


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_prefill_and_decode_logits_match_reference(runs, arch):
    """Prefill, then four teacher-forced decode steps on the server's cache
    capacity, under the (2, 2) mesh on f32 params: every step's logits (real
    vocab) within 1e-4 of the reference's sharded steps, max abs error over
    max abs.  bf16 is held to the port on one device (next test): there the
    jitted reference is no yardstick op for op."""
    t = runs["port"][f"serve/{arch}/f32/mesh"]
    j = runs["ref"][f"serve/{arch}/f32/ref"]
    V = get_arch(arch).reduced().vocab_size
    assert t.shape == j.shape == (5, 1, get_arch(arch).reduced().padded_vocab)
    for step, (a, b) in enumerate(zip(t[..., :V], j[..., :V])):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < 1e-4, (step, err)


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_sharded_prefill_logits_with_the_batch_split_match_reference(runs, arch):
    """A prefill of the loss inputs' 4 x 64 tokens, the batch split over
    'data' (the serve checks' one prompt cannot split it), on f32 params:
    the last position's logits (real vocab) within 1e-4 of the reference's
    sharded step and of the port's on one device, max abs error over max
    abs."""
    t, o = (runs["port"][f"prefill/{arch}/{k}"] for k in ("mesh", "single"))
    j = runs["ref"][f"prefill/{arch}/ref"]
    V = get_arch(arch).reduced().vocab_size
    assert t.shape == j.shape == o.shape == (4, get_arch(arch).reduced().padded_vocab)
    for want in (j, o):
        err = np.abs(t[:, :V] - want[:, :V]).max() / np.abs(want[:, :V]).max()
        assert err < 1e-4, err


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_bf16_prefill_and_decode_logits_match_one_device(runs, arch):
    """The same steps on the bf16 params and caches the server runs: every
    step's logits within ``BF16_LOGITS_TOL`` of the port's on one device on
    the same weights (bounds and readings at their definition).  MoE
    routing follows one device's; every token whose own choice differed
    is a near tie."""
    t = runs["port"][f"serve/{arch}/bf16/mesh"]
    o = runs["port"][f"serve/{arch}/bf16/single"]
    V, tol = get_arch(arch).reduced().vocab_size, BF16_LOGITS_TOL[arch]
    assert t.shape == o.shape == (5, 1, get_arch(arch).reduced().padded_vocab)
    for step, (a, b) in enumerate(zip(t[..., :V], o[..., :V])):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < tol, (step, err)
    assert all(m < BF16_TIE for m in runs["flags"][f"serve/{arch}/bf16/flips"])


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_server_tokens_equal_one_device(runs, arch):
    """Every decode call's greedy token of the sharded server on f32 params
    equals the port's server on one device; in bf16, modeled and real
    payload give the same tokens (modeled == real under the mesh)."""
    port = runs["flags"][f"serve/{arch}"]
    single = port["f32_single"]
    assert len(single["tokens"]) == single["counters"]["decode_steps"] == 12
    assert port["f32"]["tokens"] == single["tokens"]
    assert port["f32"]["log"] == single["log"]
    assert port["f32"]["counters"] == single["counters"]
    assert port["real"]["tokens"] == port["modeled"]["tokens"]
    assert len(port["real"]["tokens"]) == 12


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_sharded_real_payload_moves_local_shards(runs, arch):
    """Under the mesh the params are DTensors, the real payload plane holds
    each rank's shards and hands back DTensors, and it moved bytes."""
    real = runs["flags"][f"serve/{arch}"]["real"]
    assert real["params_dtensor"] is True
    assert real["dtensor_leaves"] is True
    assert real["swap_in_bytes_per_s"] > 0.0


def test_split_heads_prefill_and_decode_logits_match_reference(runs):
    """Query heads that do not divide over 'tp' (``SPLIT_ARCH``, 3 heads at
    tp = 2): the prefill on each rank's sequence rows through K3's entry
    (its plain version here) and decode on the whole query, f32 params,
    every step's logits within 1e-4 of the reference's sharded steps."""
    t = runs["port"][f"serve/{SPLIT_ARCH}/f32/mesh"]
    j = runs["ref"][f"serve/{SPLIT_ARCH}/f32/ref"]
    cfg = reduced_cfg(get_arch, SPLIT_ARCH)
    assert cfg.num_heads % 2 and t.shape == j.shape == (5, 1, cfg.padded_vocab)
    for step, (a, b) in enumerate(zip(t[..., :cfg.vocab_size], j[..., :cfg.vocab_size])):
        err = np.abs(a - b).max() / np.abs(b).max()
        assert err < 1e-4, (step, err)


def test_split_heads_server_matches_reference(runs):
    """The sharded server on ``SPLIT_ARCH``: assignment log and counters
    equal to the reference's sharded server's, and to one device's."""
    ref = json.loads(str(runs["ref"][f"serve/{SPLIT_ARCH}/stream"]))
    port = runs["flags"][f"split/{SPLIT_ARCH}"]
    assert ref["counters"]["swap_ins"] >= 1 and len(ref["log"]) == 6
    assert port["modeled"]["log"] == ref["log"] == port["single"]["log"]
    assert port["modeled"]["counters"] == ref["counters"] == port["single"]["counters"]


def test_split_heads_attention_runs_on_each_ranks_rows(runs):
    """Every rank's attention calls under the mesh: training (plain route)
    and prefill (K3's entry) on the rank's own S / tp query rows from their
    own first position (rank t of 'model' from row t * S / tp), against
    all S keys; decode on the one query against the rank's own cap / tp
    cache slots of each layer."""
    assert split_rows_problems(runs["flags"]) == []
    ranks = runs["flags"][f"split/{SPLIT_ARCH}"]["ranks"]
    assert sorted(r["tp_rank"] for r in ranks) == [0, 0, 1, 1]


def test_sharded_moe_decode_runs_experts_in_place(runs):
    """Reduced olmoe's decode steps under the (2, 2) mesh: on every rank
    each layer's three K4 calls (their plain version here) get the rank's
    [E / tp, C / dp, .] block of the capacity buffer and its own E / tp
    experts, and no expert weight is gathered over 'model'."""
    assert expert_block_problems(runs["flags"]) == []
    assert len(runs["flags"]["serve/olmoe-1b-7b/blocks"]) == 4


@pytest.mark.parametrize("heads", ["gqa", "mqa"])
def test_flash_attention_kv_heads_per_rank_at_tp2(runs, heads):
    """4 query heads at tp = 2: rank r's two query heads read KV head r of 2
    (GQA), or KV head 0 (MQA).  Without the per-rank KV slice the GQA
    result is wrong on the second model column."""
    t = runs["port"]
    assert float(t[f"gqa/{heads}/err"]) < 1e-6
    if heads == "gqa":
        assert float(t["gqa/gqa/naive_err"]) > 1e-2
    assert runs["flags"]["gqa/kv_span"] == [0, 1]          # rank 0 of 'model'


def test_kv_span_covers_whole_groups_or_one_head():
    from repro_torch.models.layers import _kv_span

    assert _kv_span(0, 4, 2) == (0, 2) and _kv_span(4, 4, 2) == (2, 4)
    assert _kv_span(8, 4, 16) == (0, 1) and _kv_span(28, 7, 7) == (4, 5)
    with pytest.raises(ValueError):
        _kv_span(3, 3, 2)


def test_init_process_group_refuses_master_port_zero(monkeypatch):
    """torchrun --master-port 0 hands its workers MASTER_PORT=0; joining it
    would wait for ever, so it is refused at once."""
    import torch.distributed as dist
    from repro_torch.launch import mesh

    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "0")
    with pytest.raises(RuntimeError, match="MASTER_PORT is 0"):
        mesh.init_process_group("cpu")
    assert not dist.is_initialized()


def test_torchrun_master_port_zero_fails_fast(tmp_path):
    """The launcher under ``torchrun --master-port 0`` exits with the
    refusal instead of hanging."""
    env = {**os.environ, "PYTHONPATH": str(SRC), "OMP_NUM_THREADS": "1"}
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", "0", "-m", "repro_torch.launch.train", "--arch",
         "internlm2-1.8b", "--reduced", "--steps", "1", "--device", "cpu",
         "--mesh", "host", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode != 0
    assert "MASTER_PORT is 0" in proc.stdout + proc.stderr
    assert time.monotonic() - t0 < 110



def test_port_checks_without_the_reference_pass(runs):
    """What a machine without JAX checks of these runs (``chip_smoke.py``'s
    ``gloo4`` phase): every result held to the port on one device."""
    checks = port_checks(runs["port"], runs["flags"])
    assert len(checks) >= 30
    assert [k for k, ok in checks.items() if not ok] == []
