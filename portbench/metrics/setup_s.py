"""Set-up seconds: process start to the window (data, index build, server, warm-up)."""


def read(run):
    return run.setup_s
