"""OnAlgo core (port of ``repro.core``): state space, the algorithm, the
paper's baselines, the P1 oracle (``oracle``), the Sec. V extensions
(``extensions``), the fleet engines (scan, chunked, the streaming chunked
engine and the sharded engines on torch.distributed, with multi-cloudlet
topologies; ``autotune``), the collectives of a mesh axis
(``collectives``) and the Theorem-1 terms (``theory``)."""

from repro_torch.core.state_space import (StateSpace, RhoEstimator,
                                          default_paper_space,
                                          empirical_rho)
from repro_torch.core.onalgo import (OnAlgoParams, OnAlgoState, StepRule,
                                     capacity_loads, init_state,
                                     policy_matrix, decide, step)
from repro_torch.core.fleet import (AutotuneResult, RawOverlay, Trace,
                                    autotune, simulate, simulate_chunked,
                                    simulate_chunked_stream,
                                    simulate_sharded,
                                    simulate_sharded_stream)
from repro_torch.core import (baselines, collectives, extensions, oracle,
                              theory)

__all__ = [
    "StateSpace", "RhoEstimator", "default_paper_space", "empirical_rho",
    "OnAlgoParams", "OnAlgoState", "StepRule", "capacity_loads",
    "init_state", "policy_matrix", "decide", "step", "RawOverlay", "Trace",
    "simulate", "simulate_chunked", "simulate_chunked_stream",
    "simulate_sharded", "simulate_sharded_stream", "autotune",
    "AutotuneResult", "baselines", "collectives", "extensions", "oracle",
    "theory",
]
