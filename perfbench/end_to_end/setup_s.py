"""setup_s: process start to the window's start (s)."""


def read(run):
    return run.setup_s
