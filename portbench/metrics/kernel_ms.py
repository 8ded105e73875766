"""Device ms a call of the program's ``rollout`` spans (``core/fleet.py``:
the K1 / K2 call with its wrapper's checks, and the plain tail), summed
over the call's slabs."""

from portbench import program_spans


def compute(record):
    return program_spans.device_ms("rollout")
