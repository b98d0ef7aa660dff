"""Device kernels per profiled search step."""


def read(run):
    if run.trace is None:
        return None
    return len(run.trace.kernels) / sum(run.record["profiled"])
