"""OnAlgo core (port of ``repro.core``): state space, the algorithm, the
paper's baselines, the materialized fleet engines (with multi-cloudlet
topologies) and the Theorem-1 terms (``theory``).

The oracle and extension modules and the streaming / sharded engines are
not ported yet (ROADMAP.md queue A items 5, 7, 11)."""

from repro_torch.core.state_space import (StateSpace, RhoEstimator,
                                          empirical_rho)
from repro_torch.core.onalgo import (OnAlgoParams, OnAlgoState, StepRule,
                                     capacity_loads, init_state,
                                     policy_matrix, decide, step)
from repro_torch.core.fleet import (RawOverlay, Trace, simulate,
                                    simulate_chunked)
from repro_torch.core import baselines, theory

__all__ = [
    "StateSpace", "RhoEstimator", "empirical_rho",
    "OnAlgoParams", "OnAlgoState", "StepRule", "capacity_loads",
    "init_state", "policy_matrix", "decide", "step", "RawOverlay", "Trace",
    "simulate", "simulate_chunked", "baselines", "theory",
]
