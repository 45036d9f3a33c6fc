# Fixture dispatch: the kernel layer's registry may read the environment.
import os


def default_impl():
    return os.environ.get("REPRO_KERNEL_IMPL")
