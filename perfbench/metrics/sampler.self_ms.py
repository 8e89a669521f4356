"""sampler.self_ms: per edit, the edit's CUDA-event span minus the spans
of its forwards: the partition, gathers and scatters, the Euler, jump and
reuse arithmetic, the host sync and the idle between forwards; the mean
over the traced edits."""


def read(run):
    own = [e["edit_ms"] - sum(t for _, t in e["forwards"])
           for e in run.spans if e["forwards"]]
    return sum(own) / len(own) if own else None
