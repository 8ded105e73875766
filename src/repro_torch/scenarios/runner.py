"""Scenario execution: compile a spec, pick an engine, roll it out.

Port of ``repro/scenarios/runner.py``.  Engines:
  * ``scan``    — ``fleet.simulate`` (the slot loop; any algo / baseline);
  * ``chunked`` — ``fleet.simulate_chunked`` (the fused rollout kernels:
                  K1 / K1-topo, or the device-tiled K2 / K2-topo when
                  ``block_n`` is set; OnAlgo only);
  * ``auto``    — ``chunked`` when the run's tensors are on the card,
                  ``scan`` on the CPU, where the kernels' plain versions
                  run slot by slot anyway.

``use_kernel="auto"`` likewise runs the single-slot kernel (K3) inside the
scan engine on the card only.  Both go by the run's device, never by what
the machine has.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import torch

from repro_torch.core.fleet import simulate, simulate_chunked
from repro_torch.core.onalgo import StepRule
from repro_torch.device import resolve_device
from repro_torch.scenarios.registry import compile_scenario, \
    default_scenarios
from repro_torch.scenarios.spec import CompiledScenario, Scenario


def _on_card(device) -> bool:
    """Whether a run on ``device`` (None -> cuda) runs on the card."""
    return torch.device("cuda" if device is None else device).type == "cuda"


def resolve_use_kernel(flag: Union[bool, str], device=None) -> bool:
    """'auto' -> True for a run on the card (``device``, None -> cuda)."""
    if isinstance(flag, str):
        if flag != "auto":
            raise ValueError(f"use_kernel must be bool or 'auto', got {flag!r}")
        return _on_card(device)
    return bool(flag)


def resolve_engine(engine: str, device=None) -> str:
    """'auto' -> ``chunked`` for a run on the card (``device``, None ->
    cuda), ``scan`` on the CPU."""
    if engine == "auto":
        return "chunked" if _on_card(device) else "scan"
    if engine not in ("scan", "chunked"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def run_scenario(sc: Union[Scenario, CompiledScenario, str],
                 rule: Optional[StepRule] = None,
                 algo: str = "onalgo",
                 engine: str = "auto",
                 use_kernel: Union[bool, str] = "auto",
                 chunk: int = 8,
                 block_n: Optional[int] = None,
                 with_true_rho: bool = False,
                 enforce_slot_capacity: bool = False, *, device=None):
    """Compile (if needed) and simulate one scenario.

    ``device``: where the run happens (None: a compiled scenario's own
    device, else cuda); a spec or kind name is compiled there.
    ``block_n`` routes the chunked engine through the device-tiled kernel
    (that many devices a tile; None = K1).
    Returns (series, final_state, CompiledScenario).
    """
    if isinstance(sc, str):
        sc = Scenario(kind=sc)
    if isinstance(sc, Scenario):
        sc = compile_scenario(sc, device=device)
    dev = sc.device if device is None else resolve_device(device)
    rule = rule if rule is not None else StepRule.inv_sqrt(0.5)
    multi_cloudlet = sc.topology is not None and sc.topology.K > 1
    # scan-only options pin 'auto' to the scan engine on every device; an
    # EXPLICIT engine='chunked' with them still raises below
    if engine == "auto" and (algo != "onalgo" or with_true_rho):
        engine = "scan"
    else:
        engine = resolve_engine(engine, dev)

    if engine == "chunked":
        if algo != "onalgo":
            raise ValueError("the chunked engine only rolls OnAlgo; use "
                             f"engine='scan' for algo={algo!r}")
        if with_true_rho:
            raise ValueError(
                "the chunked engine does not support with_true_rho; use "
                "engine='scan' for the Theorem-1 series")
        series, final = simulate_chunked(
            sc.trace, sc.tables, sc.params, rule, chunk=chunk,
            block_n=block_n, enforce_slot_capacity=enforce_slot_capacity,
            topology=sc.topology, device=dev)
    else:
        kw = {}
        if with_true_rho:
            if sc.true_rho is None:
                raise ValueError(
                    f"scenario kind {sc.scenario.kind!r} has no analytic "
                    "true_rho; run without with_true_rho")
            kw = dict(true_rho=sc.true_rho, with_true_rho=True)
        # the single-slot kernel is scalar-mu only; 'auto' takes the plain
        # slot step for multi-cloudlet scenarios
        uk = resolve_use_kernel(use_kernel, dev)
        if multi_cloudlet and uk:
            if use_kernel != "auto":
                raise ValueError(
                    "use_kernel (the fused single-slot dual kernel) does "
                    "not support multi-cloudlet duals; run "
                    "use_kernel=False or engine='chunked'")
            uk = False
        series, final = simulate(sc.trace, sc.tables, sc.params, rule,
                                 algo=algo,
                                 enforce_slot_capacity=enforce_slot_capacity,
                                 use_kernel=uk, topology=sc.topology,
                                 device=dev, **kw)
    return series, final, sc


def run_all_scenarios(rule: Optional[StepRule] = None,
                      engine: str = "auto", *, device=None,
                      **kw) -> Dict[str, tuple]:
    """Roll every registered kind's default spec; kind -> (series, final,
    compiled)."""
    return {sc.kind: run_scenario(sc, rule=rule, engine=engine,
                                  device=device, **kw)
            for sc in default_scenarios()}
