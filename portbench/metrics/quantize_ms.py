"""Device ms a call of the program's ``quantize`` spans (``serve/
compile.py::_lower_values``: the gathers, the risk-adjusted gain and the
quantization), summed over the call: once in a materialized lowering,
once a slab in a streamed one."""

from portbench import program_spans


def compute(record):
    return program_spans.device_ms("quantize")
