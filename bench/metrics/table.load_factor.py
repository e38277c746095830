"""The table's load factor at the end of the window's last whole fill, a
fixed key count (records over the slots of the allocated segments,
``DashTable.load_factor``): the space side of the load's trade."""


def read(rec):
    if rec.op != "insert" or "load_factor" not in rec.counters:
        return None
    return 100.0 * rec.counters["load_factor"]
