"""The 95th percentile of every completed call's time in the window, ms:
host clock from the call's start until its result is ready, linear
between order statistics."""
import statistics


def read(run):
    ms = [(s.end - s.start) * 1e3 for s in run.spans if s.ok]
    if len(ms) < 2:
        return None
    return statistics.quantiles(ms, n=20, method="inclusive")[18]
