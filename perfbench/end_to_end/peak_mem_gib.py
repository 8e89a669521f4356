"""peak_mem_gib: `torch.cuda.max_memory_allocated()` over the window,
reset at its start, weights and cache included (GiB)."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None
