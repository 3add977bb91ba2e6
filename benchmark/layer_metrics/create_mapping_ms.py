"""The benchmark's host span around create_mapping, ending in a device
synchronize, averaged over the traced requests, ms."""


def read(run):
    t = run.spans.get("create_mapping")
    return sum(t) * 1e3 / len(t) if t else None
