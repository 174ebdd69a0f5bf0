"""Device-idle ms a request in the span phase whose gap's middle falls in
``model.forward`` or one of its children, the model's solves included."""

from portbench import spans


def read(run):
    return spans.idle_ms(run, "model")
