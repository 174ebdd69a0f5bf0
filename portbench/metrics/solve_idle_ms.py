"""Device-idle ms a request in the span phase whose gap's middle falls in
a ``solve`` span or one of its children (the solve's inputs, its launch)."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "solve_any")
