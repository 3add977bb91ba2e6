"""The benchmark's host span around resample, ending in a device
synchronize, averaged over the traced requests, ms."""


def read(run):
    t = run.spans.get("resample")
    return sum(t) * 1e3 / len(t) if t else None
