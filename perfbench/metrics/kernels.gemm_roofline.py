"""kernels.gemm_roofline: the least time of the traced edits' linears
(`work.edit_items`: operations at the bf16 peak or bytes at the HBM rate,
linear by linear) over the device time of the GEMM group's kernels, in
percent."""

from perfbench import work


def read(run):
    if run.trace is None:
        return None
    dev = run.trace["by_group"].get("gemm", 0.0)
    if dev <= 0.0:
        return None
    least = sum(work.totals(work.edit_items(run.config, run.grid,
                                            e["stats"]), "gemm")[1]
                for e in run.edits)
    return 100.0 * least / dev
