"""setup_s: seconds from the process's start to the window's start (imports,
the corpus made on the device, the container built, every shape warmed up;
in a checkout's first run, the nvcc build)."""


def read(rec):
    return rec.setup_s
