"""The prefill's expert layers against their least time, in percent: the
family's `call_work` "experts" of the prefill pass (the router, the shared
experts and the routed experts the router chose, bound by their operations)
over their stream time (`moe_prefill_s`, CUDA events around the prefill's
`moe.expert_layer` calls), over the window's calls. The decode's expert
layers are left out: a step's are bound by the host's launches, so their
events time the card waiting for the host (`moe_ms` holds them)."""


def read(run):
    pairs = [(w["experts"][0].least_s, c.record["moe_prefill_s"]) for w, c in zip(run.work, run.calls)
             if w.get("experts") and c.record.get("moe_prefill_s")]
    if not pairs:
        return None
    return 100.0 * sum(a for a, _ in pairs) / sum(b for _, b in pairs)
