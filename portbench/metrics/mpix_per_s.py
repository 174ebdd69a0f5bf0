"""Restored megapixels a second over the whole window: every completed
request's output pixels over all the window's time."""


def read(run):
    if run.trace is not None or run.window_s <= 0:
        return None
    return run.requests * run.pixels_per_request / 1e6 / run.window_s
