"""device.edit_mfu: the model operations of the traced edits (every
linear and attention of the dense forwards over all rows and of the
computed RAGS forwards over the edited rows, `work.edit_items`) over the
device's span in the trace (its first operation's start to its last
one's end, the idle gaps between included) at the bf16 peak, in
percent."""

from perfbench import work


def read(run):
    if run.trace is None or not run.edits or run.trace["span_s"] <= 0.0:
        return None
    flops = sum(work.totals(work.edit_items(run.config, run.grid,
                                            e["stats"]))[0]
                for e in run.edits)
    return 100.0 * flops / (run.trace["span_s"] * work.PEAK_BF16)
