"""The window's wall over the calls completed in it."""


def read(run):
    return run.window_s / len(run.calls)
