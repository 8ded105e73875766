"""Scenario engine (port of ``repro.scenarios``): declarative fleet
workloads + batched sweeps.

Public API:
  Scenario, CompiledScenario, compose   (spec)
  register, register_modifier, names,
  compile_scenario, default_scenarios,
  SCENARIO_KINDS, MODIFIERS             (registry)
  CatalogEntry, load_catalog, load_entry,
  catalog_dir, catalog_names,
  compile_named                         (catalog: YAML named workloads)
  SweepGrid, product_grid, grid_from_cells,
  stack_rules, stack_params,
  sweep_simulate, unstack_series        (sweeps)
  run_scenario, run_all_scenarios,
  resolve_engine, resolve_use_kernel    (runner)

Compiling and running take ``device=`` (None -> cuda).
"""

from repro_torch.scenarios.spec import CompiledScenario, Scenario, compose
from repro_torch.scenarios.registry import (MODIFIERS, SCENARIO_KINDS,
                                            compile_scenario,
                                            default_scenarios, names,
                                            register, register_modifier)
from repro_torch.scenarios.catalog import (CatalogEntry, catalog_dir,
                                           catalog_names, compile_named,
                                           load_catalog, load_entry)
from repro_torch.scenarios.sweeps import (SweepGrid, grid_from_cells,
                                          product_grid, stack_params,
                                          stack_rules, sweep_simulate,
                                          unstack_series)
from repro_torch.scenarios.runner import (resolve_engine,
                                          resolve_use_kernel,
                                          run_all_scenarios, run_scenario)

__all__ = [
    "Scenario", "CompiledScenario", "compose", "MODIFIERS", "SCENARIO_KINDS",
    "compile_scenario", "default_scenarios", "names", "register",
    "register_modifier", "CatalogEntry", "catalog_dir", "catalog_names",
    "compile_named", "load_catalog", "load_entry", "SweepGrid",
    "grid_from_cells", "product_grid", "stack_params", "stack_rules",
    "sweep_simulate", "unstack_series", "resolve_engine",
    "resolve_use_kernel", "run_all_scenarios", "run_scenario",
]
