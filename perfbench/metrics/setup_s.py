"""Set-up: seconds from the process's start to the first measured one
(imports, weights, the kernel builds or their cache, warm-up traffic)."""


def read(run):
    return run.setup_s
