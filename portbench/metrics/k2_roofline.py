"""Percent of K2's roofline: the least time of the whole solves the traced
requests need (``work/solves.py``: the FFT basis at the float32 peak,
against the bytes at the HBM peak) over K2's summed device time."""

from portbench.readers import roofline


def read(run):
    return roofline(run, "k2")
