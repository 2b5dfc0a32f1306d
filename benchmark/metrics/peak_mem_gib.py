"""The card's allocator peak (``torch.cuda.max_memory_allocated``) from a
reset at the window's start to its end, GiB, on the fullest card; the
inputs the cell keeps resident are in it."""


def read(run):
    peak = max(run.peaks)
    return peak / (1 << 30) if peak > 0 else None
