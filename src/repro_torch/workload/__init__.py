"""Workload generation layer (port of ``repro.workload``): the v1
counter-based RNG contract and the service tier's processes.

The streaming lowering (``StreamingWorkload``) and the gateway's load
generator are not ported yet (ROADMAP A5, A10)."""

from repro_torch.workload import streams
from repro_torch.workload.streams import (RNG_COUNTER, RNG_LEGACY_HOST,
                                          markov_chain, stream_key)
from repro_torch.workload.service import (ServiceWorkload,
                                          arrival_chain_probs,
                                          generate_service_workload,
                                          validate_rng_version)

__all__ = [
    "RNG_COUNTER", "RNG_LEGACY_HOST", "markov_chain", "stream_key",
    "streams", "ServiceWorkload", "arrival_chain_probs",
    "generate_service_workload", "validate_rng_version",
]
