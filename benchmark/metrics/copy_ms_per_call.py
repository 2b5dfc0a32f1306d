"""Device time of host-device copies per call in the traced stretch, ms,
from the profiler's copy records."""


def read(run):
    p = run.profile
    if p is None or not p.calls():
        return None
    ns = sum(d.end - d.start for d in p.device_ops if d.kind == "copy")
    return ns / 1e6 / p.calls() if ns else None
