"""setup_s: seconds from the process's start to the window's: imports,
the kernels' build or load, the rows made, the index built, the cell's
shapes warmed and the unmeasured stretch of its traffic."""


def read(run):
    return run.setup_s
