"""Seconds from the process's start to the first timed request."""


def read(run):
    return None if run.trace is not None else run.setup_s
