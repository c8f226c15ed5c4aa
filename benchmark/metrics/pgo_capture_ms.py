"""The span "pgo.capture" mean: a pose-graph optimisation's eager first LM
iteration and its CUDA-graph capture, every call (after a loop edge and the
session's last), host clock, ms a call."""

from benchmark.records import phase_mean_ms


def read(run):
    return phase_mean_ms(run, "pgo.capture")
