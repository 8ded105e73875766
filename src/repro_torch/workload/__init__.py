"""Workload generation layer (port of ``repro.workload``): the v1
counter-based RNG contract, the service tier's processes, their
streaming (slab-addressable) lowering, and the live gateway's load
generator (``loadgen``)."""

from repro_torch.workload import streams
from repro_torch.workload.streams import (RNG_COUNTER, RNG_LEGACY_HOST,
                                          markov_chain, stream_key)
from repro_torch.workload.service import (ServiceWorkload,
                                          arrival_chain_probs,
                                          generate_service_workload,
                                          service_process,
                                          validate_rng_version)
from repro_torch.workload.streaming import (StreamingWorkload,
                                            lower_service_workload)
from repro_torch.workload.loadgen import ServiceLoadGen, Wave

__all__ = [
    "RNG_COUNTER", "RNG_LEGACY_HOST", "markov_chain", "stream_key",
    "streams", "ServiceWorkload", "StreamingWorkload",
    "arrival_chain_probs", "generate_service_workload",
    "lower_service_workload", "service_process", "validate_rng_version",
    "ServiceLoadGen", "Wave",
]
