"""Device-idle ms a request in the span phase whose gap's middle falls in
an ``entry.*`` span (the host batch's copy in, the answer's copy out and
the wait for it)."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "entry")
