"""setup_s: process start to the first timed frame (host clock): imports,
the seeded inputs, the program's build, the kernels' first use and the
warm-up dispatches with their capture."""


def read(run):
    return run.obs.setup_s
