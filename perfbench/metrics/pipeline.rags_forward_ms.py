"""pipeline.rags_forward_ms: the mean device time of one call of the
pipeline's RAGS hook (`rags_forward`: the edited rows against the frozen
cache), from CUDA events around each call."""


def read(run):
    ms = [t for e in run.spans for k, t in e["forwards"] if k == "rags"]
    return sum(ms) / len(ms) if ms else None
