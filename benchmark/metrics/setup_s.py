"""Set-up: from the process's start to the window's, host clock, s."""


def read(run):
    return run["window"]["setup_s"]
