"""Stage "mstep" (stages/mstep/): its bound at the card's peaks over the device
time of its kernels in the profiled session, %."""

from benchmark.roofline import stage_share


def read(run):
    return stage_share(run, "mstep")
