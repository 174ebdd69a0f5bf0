"""Device milliseconds a request of host-device copies (and sets)."""

from portbench.readers import COPY, per_request_ms


def read(run):
    if run.trace is None:
        return None
    return per_request_ms(run, run.trace.seconds(COPY))
