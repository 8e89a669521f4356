"""pipeline.dense_forward_ms: the mean device time of one call of the
pipeline's dense hook (`dense_forward`: the warm-up, partition, refresh
and smooth steps), from CUDA events around each call."""


def read(run):
    ms = [t for e in run.spans for k, t in e["forwards"] if k == "dense"]
    return sum(ms) / len(ms) if ms else None
