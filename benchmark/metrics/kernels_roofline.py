"""The traced calls' share of their roofline, %: the least time, their
necessary bytes (``bytes/<op>.py``: each input column the operation needs
read once, each output column written once) over the card's HBM rate
(``peaks.json``), divided by the device time of every kernel, copy and set
of those calls, summed over cards."""
import json
from pathlib import Path

PEAKS = Path(__file__).resolve().parent.parent / "peaks.json"


def read(run):
    p = run.profile
    if p is None or not p.calls():
        return None
    ns = sum(d.end - d.start for d in p.device_ops)
    need = sum(run.op_bytes[op] for op, _, _ in p.ops)
    if not ns or not need:
        return None
    with open(PEAKS) as f:
        rate = json.load(f)["hbm_bytes_per_s"]
    return 100.0 * (need / rate) / (ns / 1e9)
