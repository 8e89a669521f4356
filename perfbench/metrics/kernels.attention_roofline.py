"""kernels.attention_roofline: the least time of the traced edits'
attention work (`work.edit_items`, the larger of operations at the bf16
peak and bytes at the HBM rate, call by call) over the device time of the
attention group's kernels, in percent."""

from perfbench import work


def read(run):
    if run.trace is None:
        return None
    dev = run.trace["by_group"].get("attention", 0.0)
    if dev <= 0.0:
        return None
    least = sum(work.totals(work.edit_items(run.config, run.grid,
                                            e["stats"]), "attn")[1]
                for e in run.edits)
    return 100.0 * least / dev
