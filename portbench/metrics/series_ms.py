"""Device ms a call of the program's ``series`` spans (``core/fleet.py``:
per-slot admission and the accounting series, written into the stream's
buffers), summed over the call's slabs."""

from portbench import program_spans


def compute(record):
    return program_spans.device_ms("series")
