"""Share of the routed experts' roofline in the traced part of a serving
window, in %: the least time the grouped expert GEMMs (K4) of the traced
requests need (each miss's prefill over its prompt, each decode step's one
token; the architecture's ``expert_bound_s``: the weights of the experts
the tokens reach, read once, or the GEMMs' operations at the peak), over
the device time of the work launched in the program's ``moe.experts``
spans (K4's three launches a layer and the SwiGLU between them).  Nothing
off the card, without a trace, from a program that opens no such span, or
for an architecture whose module counts no experts."""

from portbench import spans


def read(obs):
    bound = getattr(obs.reference, "expert_bound_s", None)
    got = spans.per_span(obs, "moe.experts") if bound is not None else None
    if got is None:
        return None
    device_s = sum(e["dur"] for e in got[1]) / 1e6
    if not device_s:
        return None
    need = 0.0
    for r in obs.requests:
        if not r.in_profile or r.failed:
            continue
        if r.prefill_len:
            need += bound(obs.arch, "prefill", r.prefill_len)
        need += len(r.positions) * bound(obs.arch, "decode", 1)
    return 100.0 * need / device_s
