"""OnAlgo core (port of ``repro.core``): state space, the algorithm, the
paper's baselines and the materialized fleet engines.

The oracle, theory and extension modules and the streaming / sharded
engines are not ported yet (ROADMAP.md queue A items 5, 7, 11)."""

from repro_torch.core.state_space import (StateSpace, RhoEstimator,
                                          empirical_rho)
from repro_torch.core.onalgo import (OnAlgoParams, OnAlgoState, StepRule,
                                     init_state, policy_matrix, decide, step)
from repro_torch.core.fleet import (RawOverlay, Trace, simulate,
                                    simulate_chunked)
from repro_torch.core import baselines

__all__ = [
    "StateSpace", "RhoEstimator", "empirical_rho",
    "OnAlgoParams", "OnAlgoState", "StepRule", "init_state", "policy_matrix",
    "decide", "step", "RawOverlay", "Trace", "simulate", "simulate_chunked",
    "baselines",
]
