"""The span "preprocess.upload" mean: the host's time to pad a scan and copy
it to the device (make_cloud), ms a scan."""

from benchmark.records import phase_mean_ms


def read(run):
    return phase_mean_ms(run, "preprocess.upload")
