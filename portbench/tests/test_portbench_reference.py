"""The plain reference against the program's CPU path at a tiny size: the
one place where ``repro_torch`` is imported beside the reference."""

import json
from pathlib import Path

import pytest
import torch

from portbench.clients.service_batch import ServiceBatch
from portbench.references import onalgo_service as ref

ROOT = Path(__file__).resolve().parents[2]
CELL = Path(__file__).resolve().parent / "cell"
TINY = json.loads((CELL / "configs" / "tiny.json").read_text())
SEED = 2**33 + 17


def _traffic(name):
    t = json.loads((ROOT / "portbench" / "traffic" / f"{name}.json")
                   .read_text())
    return dict(t, warmup_requests=0, check_requests=2)


@pytest.mark.parametrize("traffic", ["horizon", "stream-tiled"])
def test_reference_equals_program(traffic):
    d = ServiceBatch(TINY, _traffic(traffic), SEED, "cpu")
    answers = {i: d.request(i) for i in range(2)}
    numbers, checked = d.check(answers)
    assert checked == 2
    assert numbers["count_gap"][0] == 0.0
    assert numbers["value_gap"][0] < 1e-6


def test_reference_layers_match_program_draws():
    """The reference's draws equal the program's workload, slot by slot."""
    from repro_torch.workload import generate_service_workload

    N, T, S = 40, 70, 512
    wl = generate_service_workload(5, T, N, S, 3, device="cpu")
    p_on, p_stay, p_init, _ = ref.chain_probs((5, 10), 8.0, 0.9)
    on = ref.uniform(ref.stream_key(5, ref.STREAM_ARRIVAL_INIT),
                     torch.arange(N, dtype=torch.int64)) < p_init
    for b in range(2):
        u = ref.block_uniforms(5, b, N, "cpu")
        for r in range(min(64, T - 64 * b)):
            on = torch.where(on, u[0, r] < p_stay, u[0, r] < p_on)
            assert torch.equal(on, wl.on[64 * b + r])
            assert torch.equal(ref.levels(u[1, r], S).int(),
                               wl.img[64 * b + r])


@pytest.mark.parametrize("config", ["fig5-100k", "fleet-1m"])
def test_control_fails(tmp_path, config):
    """The control: the reference in bfloat16, the precision below the
    configuration's float32, answers in the program's place, and the
    harness's own check at the cell's limits finds it not correct."""
    from portbench.tests.test_portbench_faults import run_tiny, tiny_cell

    result, lines = run_tiny(tiny_cell(tmp_path, config), "tiny.horizon",
                             SEED + 1, control=True)
    assert result["correct"] is False, lines
    assert any(c["value"] > c["limit"] for c in result["check"].values())
