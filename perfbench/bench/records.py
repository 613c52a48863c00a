"""Per-request records of a run, in preallocated numpy columns.

One row a request: its index in the run's stream, the host times at which
the harness submitted it and saw it retire, the keys its rows were served
with, and the program's outcome.  Columns grow by doubling; no Python
object is kept per request, so the collector has nothing to walk.
"""
from __future__ import annotations

import numpy as np


class RecordBook:
    def __init__(self, fields: dict, capacity: int = 4096):
        """``fields``: name -> (shape of one request's value, dtype)."""
        self.fields = {"i": ((), np.int64), "t_submit": ((), np.float64),
                       "t_retire": ((), np.float64), **fields}
        self.n = 0
        self.cols = {k: np.zeros((capacity,) + tuple(s), dtype=d)
                     for k, (s, d) in self.fields.items()}

    def _grow(self, need: int) -> None:
        cap = len(self.cols["i"])
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        for k, c in self.cols.items():
            new = np.zeros((cap,) + c.shape[1:], dtype=c.dtype)
            new[:self.n] = c[:self.n]
            self.cols[k] = new

    def add(self, values: dict) -> None:
        self._grow(self.n + 1)
        j = self.n
        for k, v in values.items():
            self.cols[k][j] = v
        self.n += 1

    def view(self, rows=None) -> dict:
        """The filled columns, or rows ``rows`` (an index array) of them."""
        if rows is None:
            return {k: c[:self.n] for k, c in self.cols.items()}
        return {k: c[:self.n][rows] for k, c in self.cols.items()}
