"""setup_s: seconds from the start of the run's process to the start of
its window: imports, CUDA start-up, the traffic ``Driver``'s inputs, kernel builds and
warm-up (host clock)."""


def read(rec):
    return rec.setup_s
