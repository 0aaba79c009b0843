"""setup_s: process start to the window's opening: imports, the kernel
build or its load, compile, shard generation, prep, warm-up."""


def read(run):
    return run.setup_s
