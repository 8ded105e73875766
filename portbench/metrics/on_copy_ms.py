"""Device ms a call of the program's ``on_copy`` span: the read back of
the (T, N) arrival matrix in ``serve/compile.py::compile_service``.
Nothing where the cell lowers by slabs."""

from portbench import program_spans


def compute(record):
    return program_spans.device_ms("on_copy")
