"""Multi-cloudlet topology tier (port of ``repro.topology``): the
:class:`Topology` (static or time-varying association, per-cloudlet
capacities), its constructors and ``validate_topology``.

Engines take a Topology through ``topology=`` (``fleet.simulate``,
``fleet.simulate_chunked``, ``fleet.simulate_chunked_stream``,
``serve.simulator.simulate_service``): the cloudlet dual mu becomes a
(K,) vector, each device priced by its current cloudlet's entry, with
per-cloudlet capacity admission.  A mobility walk may be carried in
streaming form (``StreamingAssoc``, ``lower_mobility_walk``).
"""

from repro_torch.topology.topology import (StreamingAssoc, Topology,
                                           lower_mobility_walk,
                                           validate_topology)

__all__ = ["StreamingAssoc", "Topology", "lower_mobility_walk",
           "validate_topology"]
