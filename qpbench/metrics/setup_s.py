"""Set-up seconds: from the start of the process (before PyTorch is
imported) to the start of the window: imports, the card's context, the
kernels built or loaded, the instance pool, the program's problems and
the warm calls."""


def read(run):
    return run.setup_s
