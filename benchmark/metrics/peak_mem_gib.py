"""The device's peak allocated memory over the window
(torch.cuda.max_memory_allocated after a reset at the window's start),
GiB."""


def read(run):
    return run["window"]["peak_bytes"] / 2 ** 30
