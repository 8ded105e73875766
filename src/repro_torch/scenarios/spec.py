"""Declarative scenario specs for fleet simulation (paper Sec. VI + beyond).

Port of ``repro/scenarios/spec.py``.  A :class:`Scenario` is plain,
serializable data: how many devices, how long, and which generator
("kind") produces the traffic, channel and value tables.  Compiling it
gives a :class:`CompiledScenario`: the core ``(Trace, tables,
OnAlgoParams)`` contract of ``core.fleet`` on a device (plus an optional
``Topology``), so every engine runs scenarios unchanged.

Non-stationarity goes through the contract: diurnal and flash-crowd kinds
shape the per-slot distribution of ``j_idx``; churn uses the null state
for absent devices; heterogeneous fleets carry (N, M) tables; outages
double the state space with w = 0 mirror states, so the threshold policy
provably never offloads while the cloudlet is down.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fleet import Trace
from repro_torch.core.onalgo import OnAlgoParams
from repro_torch.core.state_space import StateSpace, default_paper_space
from repro_torch.device import resolve_device

CYCLES_PER_TASK = 441e6  # paper Fig. 2c mean CNN task cost


@dataclasses.dataclass(frozen=True)
class Scenario:
    """Declarative fleet-scenario spec.  Plain data: round-trips via dicts.

    kind: registered generator name (``scenarios.registry``); T / N / seed:
    horizon, fleet size, RNG seed; num_w: gain levels of the state space;
    task_prob: base per-slot task probability; budget: per-device power
    budget B_n (W); cap_frac: cloudlet capacity as a fraction of one task
    per device per slot (H = N * cap_frac * CYCLES_PER_TASK); extra:
    kind-specific knobs as sorted (key, value) pairs.
    """

    kind: str
    T: int = 4000
    N: int = 8
    seed: int = 0
    num_w: int = 4
    task_prob: float = 0.6
    budget: float = 0.08
    cap_frac: float = 0.25
    extra: Tuple[Tuple[str, Any], ...] = ()

    def opt(self, key: str, default: Any) -> Any:
        """Kind-specific knob lookup with default."""
        for k, v in self.extra:
            if k == key:
                return v
        return default

    def with_extra(self, **kw: Any) -> "Scenario":
        merged = dict(self.extra)
        merged.update(kw)
        return dataclasses.replace(self, extra=tuple(sorted(merged.items())))

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["extra"] = dict(self.extra)
        return d

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Scenario":
        d = dict(d)
        extra = d.pop("extra", {})
        if isinstance(extra, dict):
            extra = tuple(sorted(extra.items()))
        else:
            extra = tuple(tuple(kv) for kv in extra)
        return Scenario(extra=extra, **d)

    @property
    def H(self) -> float:
        return self.N * self.cap_frac * CYCLES_PER_TASK

    def params(self, *, device=None) -> OnAlgoParams:
        dev = resolve_device(device)
        return OnAlgoParams(
            B=torch.full((self.N,), self.budget, dtype=torch.float32,
                         device=dev),
            H=torch.tensor(self.H, dtype=torch.float32, device=dev))


@dataclasses.dataclass
class CompiledScenario:
    """A scenario lowered to the core simulation contract on one device.

    trace / tables / params feed ``fleet.simulate`` (and friends) verbatim.
    ``true_rho`` (N, M) is the analytic stationary distribution where the
    generator knows it, else None.  ``meta`` carries the generator's
    diagnostics (numpy arrays and numbers: outage windows, ...).
    ``topology`` (a ``Topology``, or None) rides alongside: engines take it
    through ``topology=`` (``run_scenario`` passes it on).
    """

    scenario: Scenario
    trace: Trace
    tables: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    params: OnAlgoParams
    true_rho: Optional[torch.Tensor] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    topology: Optional[Any] = None  # repro_torch.topology.Topology

    @property
    def M(self) -> int:
        return int(self.tables[0].shape[-1])

    @property
    def device(self) -> torch.device:
        return self.trace.j_idx.device

    def simulate_args(self):
        """Positional args for ``fleet.simulate(trace, tables, params, ...)``."""
        return self.trace, self.tables, self.params

    def task_mask(self) -> np.ndarray:
        """(T, N) bool arrival matrix: the ``on`` argument of
        ``serve.simulator.simulate_service``, so the serving tier replays
        this scenario's traffic."""
        return self.trace.j_idx.cpu().numpy() > 0


def scenario_space(sc: Scenario) -> StateSpace:
    return default_paper_space(num_w=sc.num_w)


def compose(spec_a, spec_b: Scenario, *, device=None) -> CompiledScenario:
    """Layer scenario ``spec_b`` on top of ``spec_a``.

    ``spec_a`` is a :class:`Scenario` of any registered kind (compiled on
    ``device``, None -> cuda) or an already compiled
    :class:`CompiledScenario` (so modifier chains fold: ``compose(compose(a,
    b), c)``; the catalog compiles its modifier lists this way).
    ``spec_b.kind`` must have a registered modifier, a transform of a
    CompiledScenario through the ``(Trace, tables, params)`` contract, so
    compositions run on every engine.  Modifiers apply in order, and order
    can matter (churn after flash_crowd re-silences absent devices).  Both
    specs must describe the same (T, N) fleet.
    """
    from repro_torch.scenarios.registry import MODIFIERS, compile_scenario
    if isinstance(spec_a, CompiledScenario):
        base = spec_a
        shape_a = (base.trace.T, base.trace.N)
    else:
        base = None
        shape_a = (spec_a.T, spec_a.N)
    if shape_a != (spec_b.T, spec_b.N):
        raise ValueError(
            f"cannot compose different fleets: {shape_a} vs "
            f"{(spec_b.T, spec_b.N)}")
    if spec_b.kind not in MODIFIERS:
        raise KeyError(f"scenario kind {spec_b.kind!r} has no registered "
                       f"modifier; composable: {sorted(MODIFIERS)}")
    if base is None:
        base = compile_scenario(spec_a, device=device)
    return MODIFIERS[spec_b.kind](spec_b, base)
