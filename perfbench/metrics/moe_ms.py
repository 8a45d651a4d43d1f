"""Milliseconds a call of the expert layers: the summed stream time of every
`moe.expert_layer` call of the prefill and the decode, from the CUDA events
the family records around each and reads after the call (`moe_s`); no
synchronize is added. The decode's part includes the card's waits for the
host's launches (a decode step is bound by them). None where the program
has no expert layer."""


def read(run):
    t = [c.record["moe_s"] for c in run.calls if "moe_s" in c.record]
    return 1e3 * sum(t) / len(t) if t else None
