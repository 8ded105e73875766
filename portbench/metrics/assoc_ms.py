"""Device ms a call of the program's ``assoc`` spans (``topology/
topology.py::StreamingAssoc.slab``: a streamed mobility walk's slab of
the association regenerated by the draws kernel), summed over the call's
slabs.  Nothing where the cell's topology is not a streamed walk."""

from portbench import program_spans


def compute(record):
    return program_spans.device_ms("assoc")
