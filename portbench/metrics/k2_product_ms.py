"""K2's four product stages, each with its grid barrier, by the kernel's
own stage clock in the span phase: device ms a request."""

from portbench import spans


def read(run):
    sp = spans.of(run)
    return None if sp is None else spans.stage_ms(sp, "k2", spans.K2_PRODUCTS)
