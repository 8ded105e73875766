"""Service-accuracy regret of a gain source vs the oracle tables.

Port of ``repro/gain/regret.py``.  The paper's predictor is judged twice:
Fig. 4 scores *estimation* error, but what the system pays is *decision*
regret — the service accuracy lost by running OnAlgo on the predicted
gains instead of the true ones.  Every source replays the SAME catalog
scenario arrivals against a pool whose phi_hat/sigma are the true gains
(the oracle), and

    regret = (acc_oracle - acc_source) / acc_oracle

so ``TableGain`` scores exactly 0 and a ridge ``ModelGain`` is gated at
<= 15% mean regret over ``GATE_SCENARIOS``.  Every entry point runs on
``device`` (None -> cuda).

    python -m repro_torch.gain.regret --max-T 300 --S 256 --device cpu
"""

from __future__ import annotations

import json

import numpy as np

from repro_torch.gain.source import TableGain, as_gain_source

#: catalog entries the acceptance gate runs over (stationary + diurnal).
GATE_SCENARIOS = ("stationary", "metro_daily")

def scenario_sim(compiled, *, max_T=None, num_w_levels=8, seed=None):
    """A serving-tier ``SimConfig`` matched to a compiled catalog
    scenario: same fleet size, horizon (optionally a ``max_T`` prefix),
    budget, capacity, and quantization granularity."""
    from repro_torch.serve.simulator import SimConfig
    sc = compiled.scenario
    T = sc.T if max_T is None else min(sc.T, int(max_T))
    return SimConfig(num_devices=sc.N, T=T, B_n=sc.budget, H=sc.H,
                     algo="onalgo", num_w_levels=num_w_levels,
                     seed=sc.seed if seed is None else seed)


def scenario_regret(sources, pool, *, scenario="stationary", max_T=600,
                    engine="scan", device=None, **engine_kw):
    """Replay one catalog scenario under every source; regret vs oracle.

    ``sources`` is a dict name -> GainSource-coercible; ``pool`` must
    carry the TRUE gains in phi_hat/sigma (e.g. ``train.oracle_pool``), so
    ``TableGain`` IS the oracle.  Returns {name: {"accuracy", "regret",
    "offload_frac", "tasks"}}.
    """
    from repro_torch.scenarios import compile_named
    from repro_torch.serve.simulator import simulate_service
    compiled = compile_named(scenario, device=device)
    sim = scenario_sim(compiled, max_T=max_T)
    on = compiled.task_mask()[:sim.T]

    oracle = simulate_service(sim, pool, on=on, engine=engine,
                              gain_source=TableGain(), device=device,
                              **engine_kw)
    acc0 = max(oracle["accuracy"], 1e-9)
    out = {}
    for name, src in sources.items():
        src = as_gain_source(src)
        if isinstance(src, TableGain):
            res = oracle
        else:
            res = simulate_service(sim, pool, on=on, engine=engine,
                                   gain_source=src, device=device,
                                   **engine_kw)
        out[name] = {"accuracy": float(res["accuracy"]),
                     "regret": float((acc0 - res["accuracy"]) / acc0),
                     "offload_frac": float(res["offload_frac"]),
                     "tasks": int(res["tasks"])}
    return out


def evaluate_regret(sources, pool, *, scenarios=GATE_SCENARIOS,
                    max_T=600, engine="scan", device=None, **engine_kw):
    """Regret per source per catalog scenario + the per-source mean.

    Returns {"scenarios": {scenario: {source: row}},
             "mean_regret": {source: float}}.
    """
    per = {sc: scenario_regret(sources, pool, scenario=sc, max_T=max_T,
                               engine=engine, device=device, **engine_kw)
           for sc in scenarios}
    mean = {name: float(np.mean([per[sc][name]["regret"]
                                 for sc in scenarios]))
            for name in sources}
    return {"scenarios": per, "mean_regret": mean}


def default_sources(S=512, C=10, seed=0, *, with_seq=False, seq_steps=60,
                    device=None):
    """The standard harness line-up over a synthetic gain problem: oracle
    tables, pre-folded overlay, class-specific ridge ModelGain, and with
    ``with_seq`` the SSD sequence head trained for ``seq_steps`` steps
    (``train_seq_gain``), their weights on ``device``.

    Returns (sources dict, oracle pool)."""
    from repro_torch.gain.source import ModelGain, OverlayGain
    from repro_torch.gain.train import (fit_ridge_gain, oracle_pool,
                                        synthetic_gain_problem,
                                        train_seq_gain)
    probs, gains = synthetic_gain_problem(S=S, C=C, seed=seed)
    pool = oracle_pool(probs, gains, seed=seed)
    ridge = fit_ridge_gain(probs, gains, device=device)
    sources = {"table": TableGain(), "overlay": OverlayGain(),
               "ridge": ModelGain(ridge, probs)}
    if with_seq:
        seq, _ = train_seq_gain(probs, gains, steps=seq_steps, seed=seed,
                                device=device)
        sources["seq"] = ModelGain(seq, probs)
    return sources, pool


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenarios", default=",".join(GATE_SCENARIOS))
    p.add_argument("--max-T", type=int, default=600)
    p.add_argument("--S", type=int, default=512)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: cuda")
    p.add_argument("--seq", action="store_true",
                   help="also train + score the SSD sequence head")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    sources, pool = default_sources(S=args.S, seed=args.seed,
                                    with_seq=args.seq, device=args.device)
    report = evaluate_regret(sources, pool,
                             scenarios=tuple(args.scenarios.split(",")),
                             max_T=args.max_T, device=args.device)
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        for sc, rows in report["scenarios"].items():
            print(f"[{sc}]")
            for name, r in rows.items():
                print(f"  {name:8s} acc {r['accuracy']:.4f} "
                      f"regret {r['regret']:+.4f} "
                      f"offload {r['offload_frac']:.3f}")
        for name, m in report["mean_regret"].items():
            print(f"mean regret {name:8s} {m:+.4f}")
    return report


if __name__ == "__main__":
    main()
