"""device.idle_share: 1 - busy time / wall time of the traced edits, in
percent; busy is the union of every kernel, copy and fill in the device
trace."""


def read(run):
    if run.trace is None or run.trace["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
