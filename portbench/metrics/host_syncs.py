"""Places a call where the host waits for the card (the program's
``host_syncs`` counter: read backs and blocking copies to the card), the
median over the profiled calls."""

from portbench import program_spans


def compute(record):
    return program_spans.counter("host_syncs")
