"""The control and every planted fault come out not correct (CPU, tiny
sizes): each drives a whole run of a cell with the timed path broken
underneath, past the harness's look for a card."""
import numpy as np
import pytest

from bench import control, harness
from bench.test_bench_harness import CELLS, SEED, TINY, tiny_run


class Faulty:
    """The program with one planted fault in the call the window times:
    ``insert`` in a load mix, ``search`` in a read mix."""

    def __init__(self, inner, fault, op):
        self.inner, self.fault, self.op = inner, fault, op

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def table(self, **start):
        return FaultyTable(self.inner.table(**start), self.fault, self.op)


class FaultyTable:
    def __init__(self, t, fault, op):
        self.t, self.fault, self.op = t, fault, op

    def __getattr__(self, name):
        return getattr(self.t, name)

    def insert(self, keys, values, max_retries=256):
        if self.op != "insert":
            return self.t.insert(keys, values, max_retries=max_retries)
        n = len(keys)
        if self.fault == "unchanged":          # acknowledged, never stored
            return np.zeros(n, np.int32)
        if self.fault == "half":               # the second half left out
            st = self.t.insert(keys[:n // 2], values[:n // 2], max_retries=max_retries)
            return np.concatenate([st, np.zeros(n - n // 2, np.int32)])
        values = values.copy()                 # altered where it is stored
        values[0] ^= 1
        return self.t.insert(keys, values, max_retries=max_retries)

    def search(self, keys):
        if self.op != "search" or self.fault == "unchanged":
            return self.t.search(keys)
        n = len(keys)
        if self.fault == "half":
            f, v = self.t.search(keys[:n // 2])
            return (np.concatenate([f, np.zeros(n - n // 2, bool)]),
                    np.concatenate([v, np.zeros(n - n // 2, np.uint32)]))
        f, v = self.t.search(keys)
        v = v.copy()                           # altered where it is produced
        v[0] ^= 1
        return f, v


FAULTS = [("eh-load-uniform", "unchanged"), ("eh-load-uniform", "half"),
          ("eh-load-uniform", "altered"), ("lh-load-uniform", "unchanged"),
          ("lh-load-uniform", "half"), ("lh-load-uniform", "altered"),
          ("eh-read-zipf", "half"), ("eh-read-zipf", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_planted_fault_is_not_correct(cell, fault):
    """Each fault the cell's timed call can have: a read mix's search keeps
    no state, so "unchanged" is a load mix's fault alone."""
    found = harness.find_cell(cell, TINY[cell])
    program = harness.Program(found.config, "cpu")
    line = tiny_run(cell, system=Faulty(program, fault, found.traffic["op"]), seconds=0.1)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    """32-bit keys collide about n^2 / 2^33 times: ~29 at 500k records."""
    over = {"setup": {"records": 500_000}}
    if harness.find_cell(cell).traffic["op"] == "search":
        over["traffic"] = {"batch": 65536}
    line = control.run(cell, SEED, 0.3, over)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())
