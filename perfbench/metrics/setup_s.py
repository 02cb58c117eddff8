"""setup_s: seconds from the start of the process to the opening of the
window (imports, weights made from the seed, the 2T preparation, the
kernels built or loaded, every step shape warmed)."""


def read(run):
    return run.setup_s
