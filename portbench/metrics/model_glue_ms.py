"""Device milliseconds a request of everything that is neither a
convolution, nor one of the program's hand-written kernels, nor a copy:
sorts, scans, reductions, elementwise."""

from portbench.readers import CONV, COPY, PORT_KERNELS, per_request_ms


def read(run):
    if run.trace is None:
        return None
    glue = run.trace.seconds(".", exclude=f"{CONV}|{COPY}|{PORT_KERNELS}")
    return per_request_ms(run, glue)
