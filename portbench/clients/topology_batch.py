"""Client of the multi-cloudlet cells: ``service_batch``'s closed loop,
one caller sending ``simulate_service`` calls back to back, each over
the deployment's K cloudlets (``repro_torch.topology.Topology``, built
inside the request from the configuration's ``topology`` entry: a
mobility walk takes the request's workload seed, on its own stream).

The check holds a sample of the answers against the plain reference of
the configuration (``references/onalgo_topology_service.py``, which
reads the topology from the deployment), as ``service_batch`` does, and
reads one number more: ``duals_idle``, the share of the window's answers
whose capacity duals all ended at 0 (limit 0: a cell whose capacity
never binds does not exercise the K-vector duals).
"""

from __future__ import annotations

import torch

from portbench import topology_counts
from portbench.clients.service_batch import ServiceBatch


class TopologyBatch(ServiceBatch):
    """One cell over K cloudlets: ``request(i)`` builds the i-th
    request's topology and runs its call."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.sim["topology"] = dict(config["topology"])

    def topology(self, wl_seed: int):
        """The request's topology (the capacity H split over its K)."""
        from repro_torch.topology import Topology
        t, sim = self.sim["topology"], self.sim
        N, H = sim["num_devices"], sim["H"]
        if t["kind"] == "mobility_walk":
            return Topology.mobility_walk(
                int(t["K"]), N, sim["T"], H, p_handover=t["p_handover"],
                seed=int(wl_seed), streaming=bool(t["streaming"]),
                device=self.device)
        return getattr(Topology, t["kind"])(int(t["K"]), N, H,
                                            device=self.device)

    def _call(self, wl_seed: int) -> dict:
        if self.control_dtype is not None:
            return super()._call(wl_seed)  # the reference reads the topology
        from repro_torch.serve.simulator import SimConfig, simulate_service
        fields = {k: v for k, v in self.sim.items() if k != "topology"}
        sim = SimConfig(**{**fields, "seed": int(wl_seed),
                           "burst_len": tuple(fields["burst_len"])})
        out = simulate_service(sim, self.program_pool, device=self.device,
                               topology=self.topology(wl_seed),
                               **self.traffic["call"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def cost(self) -> dict:
        """The counted least work of one call (``topology_counts``)."""
        t = self.sim["topology"]
        walk = t["kind"] == "mobility_walk"
        return topology_counts.service_call(
            int(self.sim["T"]), int(self.sim["num_devices"]),
            3 * 3 * int(self.sim["num_w_levels"]) + 1, self.pool.S,
            int(t["K"]), draws_in_engine=not self.traffic["call"].get(
                "materialize", True),
            walk=walk, walk_in_engine=walk and bool(t.get("streaming")))

    def check(self, answers: dict):
        numbers, checked = super().check(answers)
        idle = sum(1 for a in answers.values() if not a["mu_final"] > 0)
        numbers["duals_idle"] = (idle / max(len(answers), 1),
                                 self.config["limits"]["duals_idle"])
        return numbers, checked


def setup(config: dict, traffic: dict, seed: int, device):
    return TopologyBatch(config, traffic, seed, device)
