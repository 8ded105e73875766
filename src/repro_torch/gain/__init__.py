"""Gain-predictor tier (port of ``repro.gain``): where the offloading-gain
estimate comes from.

Public surface:

  GainSource, GainTables, TableGain, OverlayGain, ModelGain,
  snap_to_grid, as_gain_source                       (source)
  RidgeGainModel, SeqGainModel, SeqGainConfig        (model)
  gain_pairs, synthetic_gain_problem, oracle_pool,
  trace_history, fit_ridge_gain, train_seq_gain,
  save_ridge, load_ridge                             (train)
  evaluate_regret, scenario_regret, default_sources,
  GATE_SCENARIOS                                     (regret)

Every engine takes a ``gain_source=`` (``simulate_service``,
``compile_service`` / ``compile_service_streaming``,
``GatewayCore.for_sim``); ``None`` / ``TableGain`` / ``OverlayGain``
reproduce today's decision streams bit for bit, ``ModelGain`` puts a
predictor in the loop.  ``train_seq_gain`` trains the SSD head on the
port's trainer; ``save_ridge`` / ``load_ridge`` write and read the
reference's checkpoint format.
"""

from repro_torch.gain.model import RidgeGainModel, SeqGainConfig, SeqGainModel
from repro_torch.gain.regret import (GATE_SCENARIOS, default_sources,
                                     evaluate_regret, scenario_regret)
from repro_torch.gain.source import (GainSource, GainTables, ModelGain,
                                     OverlayGain, TableGain, as_gain_source,
                                     snap_to_grid)
from repro_torch.gain.train import (fit_ridge_gain, gain_pairs, load_ridge,
                                    oracle_pool, save_ridge,
                                    synthetic_gain_problem, trace_history,
                                    train_seq_gain)

__all__ = [
    "GainSource", "GainTables", "TableGain", "OverlayGain", "ModelGain",
    "snap_to_grid", "as_gain_source",
    "RidgeGainModel", "SeqGainModel", "SeqGainConfig",
    "gain_pairs", "synthetic_gain_problem", "oracle_pool",
    "trace_history", "fit_ridge_gain", "train_seq_gain",
    "save_ridge", "load_ridge",
    "evaluate_regret", "scenario_regret", "default_sources",
    "GATE_SCENARIOS",
]
