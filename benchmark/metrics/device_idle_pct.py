"""Share of the traced stretch in which no kernel, copy or set ran on the
card (the union of the profiler's device intervals), %; on several cards
the mean over cards."""


def read(run):
    p = run.profile
    if p is None or p.window_ns <= 0 or not p.device_ops:
        return None
    return 100.0 * (1.0 - p.mean_busy_ns() / p.window_ns)
