"""setup_s: seconds from the run's start to the end of its warm call (imports,
the port's kernels and host libraries, the service, the warm call), less
the time spent making inputs that the cache did not hold."""


def read(run):
    return run.setup_s
