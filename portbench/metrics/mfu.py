"""Percent of the card's dense TF32 peak that the traced window's useful
flops reach: the entry's work count a request (``work/<entry>.py``: the
model's convolutions and linear layers as they are, every solve on the FFT
basis), times the requests, over the window's length."""


def read(run):
    if run.trace is None or run.peaks is None or run.trace.window_s <= 0:
        return None
    flops = run.work["flops"] * run.trace.requests
    return 100.0 * flops / run.trace.window_s / run.peaks["tf32_flops"]
