"""Device milliseconds a request of convolution kernels (cuDNN)."""

from portbench.readers import CONV, per_request_ms


def read(run):
    if run.trace is None:
        return None
    return per_request_ms(run, run.trace.seconds(CONV))
