"""Share of attention's roofline in the traced part of a serving window,
in %: the least time the attention work of the traced requests needs
(each miss's causal prefill over its prompt, each decode step over the
keys up to its position; the architecture's ``attention_bound_s``), over
the device time of the kernels launched in the models' ``attn_scores``
regions.  Nothing without a device trace or without attention kernels
in it."""


def read(obs):
    if not obs.on_card or obs.trace is None:
        return None
    device_s = obs.trace.region_device_s("attn_scores")
    if not device_s:
        return None
    need = 0.0
    for r in obs.requests:
        if not r.in_profile or r.failed:
            continue
        if r.prefill_len:
            need += obs.reference.attention_bound_s(obs.arch, "prefill", r.prefill_len)
        for p in r.positions:
            need += obs.reference.attention_bound_s(obs.arch, "decode", p + 1)
    return 100.0 * need / device_s
