"""The 95th percentile of every request's wall time in the window, ms."""

from benchmark.harness import quantile


def read(run):
    return quantile([t * 1e3 for t in run.latencies_s], 95) if run.requests else None
