from .api import (
    OPT8BIT_PARAM_THRESHOLD,
    Spec,
    attn_chunk,
    cache_init,
    init_opt_state,
    init_params,
    input_specs,
    is_encdec,
    make_decode_step,
    make_loss_fn,
    make_prefill_step,
    make_step,
    make_train_step,
    param_specs,
    synth_inputs,
    use_8bit_opt,
)

__all__ = [
    "OPT8BIT_PARAM_THRESHOLD", "Spec", "attn_chunk", "cache_init", "init_opt_state",
    "init_params", "input_specs", "is_encdec", "make_decode_step", "make_loss_fn",
    "make_prefill_step", "make_step", "make_train_step", "param_specs",
    "synth_inputs", "use_8bit_opt",
]
