"""setup_s (s): process start to the window's start."""


def read(run):
    return run.setup_s
