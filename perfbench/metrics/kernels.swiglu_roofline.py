"""kernels.swiglu_roofline: the least time of the traced edits' SwiGLU
gates (K11; `work.edit_items`' ("op", "swiglu", bytes) items of
`reference/flux2.py`, each input read once and the output written once,
at the HBM rate) over the device time of the `swiglu` group's kernels, in
percent.  None where the trace holds no such kernel."""

from perfbench import work


def read(run):
    if run.trace is None:
        return None
    dev = run.trace["by_group"].get("swiglu", 0.0)
    if dev <= 0.0:
        return None
    least = sum(work.totals(work.edit_items(run.config, run.grid,
                                            e["stats"]), "swiglu")[1]
                for e in run.edits)
    return 100.0 * least / dev
