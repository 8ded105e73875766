"""ROADMAP C3 on both packages' own pools, on the CPU.

The reference's ``tests/test_serve.py::TestSimulator::test_policy_ordering``
asks, on ``make_scenario("hard", seed=0)``'s pool, that OnAlgo's service
accuracy beat local-only by 0.02 and stay within 0.03 of always-offload
(ocos) while spending under 0.6 of its power.  This runs that check on
the reference's pool (its JAX-trained classifiers) and on the port's
(classifiers trained by the port from its own generators), each served
by its own package's scan engine, and prints the numbers and verdicts.

    PYTHONPATH=src python scripts/c3_policy_ordering.py   (~30 s)
"""

import torch


def check(label, simulate_service, SimConfig, pool, pair, **kw):
    res = {algo: simulate_service(SimConfig(
        num_devices=4, T=800, algo=algo, B_n=0.06, H=2 * 441e6, seed=1),
        pool, **kw) for algo in ("local", "onalgo", "ocos")}
    acc = {a: r["accuracy"] for a, r in res.items()}
    power = {a: r["avg_power_per_dev"] for a, r in res.items()}
    verdicts = (acc["onalgo"] > acc["local"] + 0.02,
                power["onalgo"] < 0.6 * power["ocos"],
                acc["onalgo"] > acc["ocos"] - 0.03)
    print(f"{label}: classifiers local {pair.local_acc:.4f} cloudlet "
          f"{pair.cloud_acc:.4f}; accuracy local {acc['local']:.4f} onalgo "
          f"{acc['onalgo']:.4f} ocos {acc['ocos']:.4f} (bar ocos - 0.03 = "
          f"{acc['ocos'] - 0.03:.4f}); power onalgo {power['onalgo']:.5f} "
          f"ocos {power['ocos']:.5f}; checks (beats local, power, within "
          f"0.03 of ocos) {verdicts}")


def main():
    from repro.serve import simulator as ref
    from repro_torch.serve import simulator as port
    torch.set_num_threads(4)
    _, pair, _, pool = ref.make_scenario("hard", seed=0)
    check("reference", ref.simulate_service, ref.SimConfig, pool, pair)
    _, pair, _, pool = port.make_scenario("hard", seed=0, device="cpu")
    check("port", port.simulate_service, port.SimConfig, pool, pair,
          device="cpu")


if __name__ == "__main__":
    main()
