"""The driver's PhaseTimer "pgo" mean: one pose-graph optimisation after an
accepted loop edge, host wall clock, ms a call."""

from benchmark.records import phase_mean_ms


def read(run):
    return phase_mean_ms(run, "pgo")
