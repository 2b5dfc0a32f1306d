"""Device kernels launched per call in the traced stretch, the port's and
torch's, counted from the profiler's kernel records."""


def read(run):
    p = run.profile
    if p is None or not p.calls():
        return None
    n = sum(1 for d in p.device_ops if d.kind == "kernel")
    return n / p.calls() if n else None
