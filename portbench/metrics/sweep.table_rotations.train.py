"""Rotations of a whole frozen table into the sweep's eigenbasis per
epoch in the traced window: the program's ``sweep.rotate_table`` spans
(one a sweep that gathers its rotated slabs from the rotated table; 0
where every slab is multiplied by the basis itself)."""

from portbench.spans import count


def read(trace: dict, cell):
    return count(trace, "sweep.rotate_table")
