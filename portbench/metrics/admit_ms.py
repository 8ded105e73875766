"""Device ms a call of the program's ``admit`` spans (``core/fleet.py::
_series_from_offloads``: per-slot admission under the capacity, one
cloudlet's or each of K cloudlets'), summed over the call's slabs."""

from portbench import program_spans


def compute(record):
    return program_spans.device_ms("admit")
