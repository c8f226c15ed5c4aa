"""The driver's PhaseTimer "preprocess" mean: the host's time to upload a
scan and enqueue its preprocess (sort, radius, moments, covariances), ms."""

from benchmark.records import phase_mean_ms


def read(run):
    return phase_mean_ms(run, "preprocess")
