"""edit_s: the window's wall time over the edits completed in it (s)."""


def read(run):
    return run.window_s / len(run.edits) if run.edits else None
