"""Client of the batch service cells: one caller sends
``repro_torch.serve.simulator.simulate_service`` calls back to back
(closed loop), each over the deployment of the cell's configuration with
a workload seed of its own, drawn from the run's seed.

The traffic file gives the engine arguments of the call (``call``), the
warm-up and check sizes; the configuration file gives the deployment
(its ``SimConfig`` fields) and the pool.  The answer of a request is the metrics dict the
call returns; ``check`` holds a sample of them against the plain
reference (``references/<config reference>.py``) once the window has
closed; ``use_control`` puts that reference, in the precision below the
configuration's, in the program's place.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench import counts
from portbench.pool import make_pool

# (span, module, attribute): the layers' entry points, wrapped by the
# harness in a traced run (simulate_service imports them at call time);
# a materialized call passes through the first of each pair, a streamed
# one through the second
SPANS = {True: (("lower", "repro_torch.serve.compile", "compile_service"),
                ("engine", "repro_torch.core.fleet", "simulate_chunked")),
         False: (("lower_stream", "repro_torch.serve.compile",
                  "compile_service_streaming"),
                 ("engine", "repro_torch.core.fleet",
                  "simulate_chunked_stream"))}
FOLD = ("fold", "repro_torch.serve.compile", "service_metrics")

COUNT_KEYS = ("accuracy", "offload_frac", "admit_frac", "avg_delay_ms",
              "tasks")
VALUE_KEYS = ("avg_power_per_dev", "avg_load", "mu_final")

# the control's precision: the nearest below the configuration's
CONTROL = {"float32": torch.bfloat16}


SIM_KEYS = ("num_devices", "T", "B_n", "v_risk", "burst_len", "mean_gap",
            "step_a", "num_w_levels", "algo")


def deployment(config: dict) -> dict:
    """The run's ``SimConfig`` fields from the configuration, with the
    capacity H = tasks a slot per device * N * 441e6 cycles."""
    sim = {k: config[k] for k in SIM_KEYS}
    sim["H"] = config["H_tasks_per_device"] * sim["num_devices"] * 441e6
    return sim


def gaps(got: dict, want: dict) -> dict:
    """The widest relative gap of the count metrics (ratios of whole
    numbers: decisions, admissions, tasks) and of the value metrics
    (sums of float32 values, the last dual), |got - want| / |want| (0
    where both are 0)."""
    def rel(k):
        g, w = float(got[k]), float(want[k])
        if g == w:
            return 0.0
        return abs(g - w) / abs(w) if w != 0 else float("inf")
    return {"count_gap": max(rel(k) for k in COUNT_KEYS),
            "value_gap": max(rel(k) for k in VALUE_KEYS)}


class ServiceBatch:
    """One cell: the pool and the seeds of ``seed``; ``request(i)`` runs
    the i-th call."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from repro_torch.serve.simulator import PrecomputedPool

        self.config, self.traffic = config, traffic
        self.device = torch.device(device)
        ss = np.random.SeedSequence(int(seed) % 2**64)
        pool_ss, warm_ss, win_ss, self.check_ss = ss.spawn(4)
        p = config["pool"]
        self.pool = make_pool(p["S"], p["C"],
                              int(pool_ss.generate_state(1)[0]))
        self.program_pool = PrecomputedPool(**{
            k: getattr(self.pool, k) for k in (
                "local_correct", "cloud_correct", "d_local", "phi_hat",
                "sigma", "cycles")})
        self.sim = deployment(config)
        self._warm = np.random.default_rng(warm_ss)
        self._window = np.random.default_rng(win_ss)
        self.seeds = []  # the window's request seeds, in order
        self.devslots = self.sim["num_devices"] * self.sim["T"]
        # the entry points this cell's calls pass through (``Spans``)
        self.spans = SPANS[bool(traffic["call"].get("materialize", True))] + (
            FOLD,)
        self.control_dtype = None  # see ``use_control``
        self.reference = importlib.import_module(
            f"portbench.references.{config['reference']}")

    def use_control(self):
        """Put the control in the program's place: each request is
        answered by the plain reference computed in the precision below
        the configuration's (``CONTROL``), and ``check`` judges those
        answers as it judges the program's."""
        self.control_dtype = CONTROL[self.config["precision"]]

    def _call(self, wl_seed: int) -> dict:
        if self.control_dtype is not None:
            return self.reference.service_reference(
                self.sim, self.pool, int(wl_seed), device=self.device,
                dtype=self.control_dtype)
        from repro_torch.serve.simulator import SimConfig, simulate_service
        sim = SimConfig(**{**self.sim, "seed": int(wl_seed),
                           "burst_len": tuple(self.sim["burst_len"])})
        out = simulate_service(sim, self.program_pool, device=self.device,
                               **self.traffic["call"])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return out

    def warmup(self):
        for _ in range(int(self.traffic["warmup_requests"])):
            self._call(self._warm.integers(0, 2**62))

    def request(self, i: int) -> dict:
        """The next request of the window: its seed is the i-th drawn."""
        while len(self.seeds) <= i:
            self.seeds.append(int(self._window.integers(0, 2**62)))
        return self._call(self.seeds[i])

    def cost(self) -> dict:
        """The counted least work of one call (``counts``)."""
        M = 3 * 3 * int(self.sim["num_w_levels"]) + 1
        return counts.service_call(
            int(self.sim["T"]), int(self.sim["num_devices"]), M,
            self.pool.S, draws_in_engine=not self.traffic["call"].get(
                "materialize", True))

    def check(self, answers: dict):
        """Hold a sample of the window's answers ({index: metrics dict},
        drawn from the seed) against the plain reference in the
        configuration's float32; returns ({number: (value, limit)} with
        the widest gaps over the sample, the requests checked)."""
        k = min(int(self.traffic["check_requests"]), len(answers))
        pick = np.random.default_rng(self.check_ss).choice(
            sorted(answers), size=k, replace=False)
        worst = {"count_gap": 0.0, "value_gap": 0.0}
        for i in sorted(int(x) for x in pick):
            want = self.reference.service_reference(
                self.sim, self.pool, self.seeds[i], device=self.device)
            for name, v in gaps(answers[i], want).items():
                worst[name] = max(worst[name], v)
        limits = self.config["limits"]
        return {name: (v, limits[name]) for name, v in worst.items()}, k


def setup(config: dict, traffic: dict, seed: int, device):
    return ServiceBatch(config, traffic, seed, device)
