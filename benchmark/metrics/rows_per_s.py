"""Rows completed per second: every row of every call that completed in
the window (a sort's keys, a query's input rows, both tables for a join),
over the window's whole time, host clock."""


def read(run):
    rows = sum(s.rows for s in run.spans if s.ok)
    return rows / run.window_s if rows and run.window_s > 0 else None
