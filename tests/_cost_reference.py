"""The reference's side of ``test_torch_cost.py``, in a process of its own:
importing ``repro.launch.dryrun`` or ``perf`` sets ``XLA_FLAGS`` to 512
host devices, which must not reach the test process.

    python tests/_cost_reference.py <out.json> [<i> <n>]

Part ``i`` of ``n`` (default: all of it, 0 of 1) compiles every n-th cell
of ``HLO_CELLS`` from the i-th; part 0 also writes the rest.  Writes
``model_flops`` and the three kernel models of ``repro.launch.perf``
for every (arch x shape) cell on both production meshes, and the
per-device ``dot_flops`` of ``analyze_hlo_text`` for every reduced cell
(``HLO_CELLS``: 13 decode, 10 prefill, 10 train) on a (2, 2) mesh of 4 of 8
forced host devices (``Auto`` axes, as ``tests/_sharded_reference.py``
builds it), those of the ``attn_scores`` region (``region_costs``) for
``TP8_CELLS`` on a (1, 8) mesh of all 8, whose 4 query heads do not
divide over 'model', and the whole step's for ``TP8_DECODE`` there (its
decode attention is not in the region of the compiled step); each cell
built as the reference's ``build_cell`` builds a cell.
"""

import os

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import json  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from repro.configs import all_archs, cells  # noqa: E402

# every (arch, shape) cell of the configs, each reduced
HLO_CELLS = tuple((a, s.name) for a, cfg in all_archs().items() for s in cells(cfg))

TP8_CELLS = (("internlm2-1.8b", "prefill_32k"), ("internlm2-1.8b", "train_4k"))
TP8_DECODE = ("internlm2-1.8b", "decode_32k")


def compiled_text(arch, shape_name, mesh):
    from repro.configs import SHAPES, get_arch
    from repro.launch.mesh import make_ctx
    from repro.launch.shardings import (
        batch_specs,
        opt_state_specs,
        step_out_shardings,
        with_shardings,
    )
    from repro.models import init_opt_state, input_specs, make_step, param_specs
    from repro.models.sharding import tree_param_specs

    cfg, shape = get_arch(arch).reduced(), SHAPES[shape_name].reduced()
    ctx = make_ctx(mesh)
    pspecs = param_specs(cfg)
    params_in = with_shardings(ctx, pspecs, tree_param_specs(ctx, pspecs))
    bspecs = input_specs(cfg, shape)
    batch_in = with_shardings(ctx, bspecs, batch_specs(ctx, cfg, shape, bspecs))
    step = make_step(cfg, shape, ctx)
    if shape.kind == "train":
        ospecs = jax.eval_shape(lambda p: init_opt_state(p, cfg), pspecs)
        opt_in = with_shardings(ctx, ospecs, opt_state_specs(ctx, pspecs, ospecs))
        args = (params_in, opt_in, batch_in)
    else:
        args = (params_in, batch_in)
    out_sh = step_out_shardings(ctx, shape.kind, jax.eval_shape(step, *args))
    donate = (0, 1) if shape.kind == "train" else ((1,) if shape.kind == "decode" else ())
    fn = jax.jit(step, donate_argnums=donate, out_shardings=out_sh)
    with mesh:
        return fn.lower(*args).compile().as_text()


def main():
    jax.devices()                   # 8 host devices, before perf's import
    from repro.launch.hlo_analysis import analyze_hlo_text

    i, n = (int(a) for a in sys.argv[2:4]) if len(sys.argv) > 2 else (0, 1)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    out = {"hlo_dot_flops": {f"{a}|{s}": analyze_hlo_text(compiled_text(a, s, mesh)).dot_flops
                             for a, s in HLO_CELLS[i::n]}}
    if i == 0:
        out.update(rest())
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)


def rest():
    """The kernel models of every cell and the (1, 8) mesh's counts."""
    from repro.configs import SHAPES
    from repro.launch.hlo_analysis import analyze_hlo_text, region_costs
    from repro.launch.perf import (
        flash_kernel_model,
        model_flops,
        rglru_kernel_model,
        wkv_kernel_model,
    )

    models = {}
    for name, cfg in all_archs().items():
        for s in cells(cfg):
            shape = SHAPES[s.name]
            for n_dev, mesh_shape in ((256, (16, 16)), (512, (2, 16, 16))):
                models[f"{name}|{s.name}|{n_dev}"] = {
                    "model_flops": model_flops(cfg, shape),
                    "flash": flash_kernel_model(cfg, shape, n_dev, mesh_shape),
                    "wkv": wkv_kernel_model(cfg, shape, n_dev),
                    "rglru": rglru_kernel_model(cfg, shape, n_dev)}
    mesh8 = jax.sharding.Mesh(np.array(jax.devices()).reshape(1, 8), ("data", "model"))
    tp8 = {f"{a}|{s}": region_costs(compiled_text(a, s, mesh8),
                                    ["attn_scores"])["attn_scores"].dot_flops
           for a, s in TP8_CELLS}
    tp8_decode = analyze_hlo_text(compiled_text(*TP8_DECODE, mesh8)).dot_flops
    return {"models": models, "tp8_attn_dot_flops": tp8, "tp8_decode_dot_flops": tp8_decode}


if __name__ == "__main__":
    main()
