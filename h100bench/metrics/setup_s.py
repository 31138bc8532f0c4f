"""Set-up: from the start of the process to the first release (host
clock).  It holds the program's start, the weights, warm-up, the measured
profile and the planning of the arrivals."""


def read(run):
    return run.setup_s
