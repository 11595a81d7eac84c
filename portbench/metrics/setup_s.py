"""setup_s: seconds from the start of the process to the window: imports,
the CUDA context, the kernel library and the C++ engine (built in the
checkout on its first run), the fields, the index builds, one warm-up
request and, in a decode cell, the streams it decodes."""


def read(run):
    return run.setup_s
