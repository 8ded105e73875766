"""The port's analysis layer (``repro_torch.analysis``) against the JAX
package's: the collectives' wire model on calls mirroring
tests/test_analysis.py's HLO sample, the roofline table's text, and the
trace's FLOP / byte / peak counts on the CPU.
"""

import json
import sys

import pytest
import torch
from test_analysis import SAMPLE_HLO
from torch.utils.flop_counter import FlopCounterMode

from repro.analysis import hlo_stats as ref_stats
from repro.analysis import roofline as ref_roofline
from repro_torch.analysis import hlo_stats, roofline

F = torch.ops._c10d_functional


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


# the traced calls SAMPLE_HLO's instructions stand for: an async
# all-gather's wait is its "-done" twin, a matrix product no collective
SAMPLE_CALLS = [
    (F.all_gather_into_tensor.default, _meta((16, 1024), torch.float32)),
    (F.all_reduce.default, _meta((256, 128), torch.bfloat16)),
    (F.reduce_scatter_tensor.default, _meta((64,), torch.float32)),
    (torch.ops._dtensor.shard_dim_alltoall.default,
     _meta((8, 8), torch.float32)),
    ("collective-permute", _meta((32,), torch.bfloat16)),
    (F.all_gather_into_tensor.default, _meta((16, 1024), torch.float32)),
    (F.wait_tensor.default, _meta((16, 1024), torch.float32)),
    (torch.ops.aten.mm.default, _meta((128, 128), torch.float32)),
]


def test_collective_stats_match_reference():
    got = hlo_stats.collective_stats(SAMPLE_CALLS)
    want = ref_stats.collective_stats(SAMPLE_HLO)
    assert got == want
    assert got["all-gather"]["count"] == 2


@pytest.mark.parametrize("op,kind", [
    ("_c10d_functional.all_gather_into_tensor_coalesced.default",
     "all-gather"),
    ("_c10d_functional.reduce_scatter_tensor_coalesced.default",
     "reduce-scatter"),
    ("_c10d_functional.all_reduce_coalesced.default", "all-reduce"),
    ("_c10d_functional.all_to_all_single.default", "all-to-all"),
])
def test_coalesced_and_named_ops(op, kind):
    res = [_meta((4, 4), torch.float32), _meta((2,), torch.bfloat16)]
    got = hlo_stats.collective_stats([(op, res)])
    assert got[kind] == {"count": 1, "bytes": 64 + 4}
    assert got["total_wire_bytes"] == int(
        ref_stats._WIRE_MULT[kind] * (64 + 4))


def test_non_collectives_ignored():
    got = hlo_stats.collective_stats(
        [(torch.ops.aten.mm.default, _meta((128, 128), torch.float32))])
    assert got == ref_stats.collective_stats(
        "%dot = f32[128,128]{1,0} dot(%a, %b)") == {"total_wire_bytes": 0}


def _rec(c, m, x, mode="train", mf=0.5, cols=None, arch="a", shape="s"):
    r = {"compute_s": c, "memory_s": m, "collective_s": x}
    r["dominant"] = max(r, key=r.get)
    return {"arch": arch, "shape": shape, "status": "ok", "mode": mode,
            "mf_ratio": mf,
            "collectives": cols or {"all-gather": {"count": 1, "bytes": 10},
                                    "reduce-scatter": {"count": 2,
                                                       "bytes": 30},
                                    "total_wire_bytes": 40},
            "roofline": r}


RECORDS = [
    _rec(1.0, 2.0, 4.0),  # collective-bound: the biggest op named
    _rec(5.0, 2.0, 1.0, arch="b"),  # compute-bound
    _rec(1e-4, 2e-3, 1e-3, mode="decode", arch="c", shape="decode_32k"),
    _rec(1e-3, 2e-2, 1e-3, mf=0.3, arch="d"),  # remat / fp32 traffic
    _rec(1e-3, 2e-2, 1e-3, mf=0.9, mode="prefill", arch="e"),
    _rec(0.0, 0.0, 0.0, arch="f"),  # nothing measured: fraction 0
    {"arch": "yi-9b", "shape": "long_500k", "status": "skipped",
     "reason": "skipped: long_500k requires sub-quadratic attention; "
               "yi-9b is full-attention (see DESIGN.md)"},
    {"arch": "g", "shape": "s", "status": "error", "error": "E"},
    {"arch": "h", "shape": "s", "status": "ok"},  # no roofline
]


@pytest.mark.parametrize("i", range(len(RECORDS)))
def test_advice_and_frac_match_reference(i):
    rec = RECORDS[i]
    assert roofline.advice(rec) == ref_roofline.advice(rec)
    assert roofline.frac(rec) == ref_roofline.frac(rec)


def test_markdown_table_and_summary_match_reference():
    assert roofline.markdown_table(RECORDS) == \
        ref_roofline.markdown_table(RECORDS)
    assert roofline.summary(RECORDS) == ref_roofline.summary(RECORDS)
    assert roofline.summary(RECORDS[6:]) == ref_roofline.summary(
        RECORDS[6:]) == {}


def test_main_prints_the_reference_s_text(tmp_path, monkeypatch, capsys):
    for i, rec in enumerate(RECORDS):
        (tmp_path / f"cell{i}_single.json").write_text(json.dumps(rec))
    (tmp_path / "other_multi.json").write_text(json.dumps(RECORDS[0]))
    out = {}
    for name, mod in (("port", roofline), ("ref", ref_roofline)):
        monkeypatch.setattr(sys, "argv", ["roofline", "--dir",
                                          str(tmp_path)])
        mod.main()
        out[name] = capsys.readouterr().out
    assert out["port"] == out["ref"]
    assert "worst roofline fraction" in out["port"]
    assert roofline.load_cells(str(tmp_path), "multi") == [RECORDS[0]]


def _mlp_step(gen):
    x = torch.randn((8, 16), generator=gen)
    w1 = torch.randn((16, 32), generator=gen, requires_grad=True)
    w2 = torch.randn((32, 4), generator=gen, requires_grad=True)
    loss = (torch.relu(x @ w1) @ w2).logsumexp(-1).sum()
    return torch.autograd.grad(loss, [w1, w2])


def test_flops_equal_flop_counter_mode():
    """On plain tensors (a mesh of one) the trace counts what
    FlopCounterMode counts, forward and backward."""
    with FlopCounterMode(display=False) as fc:
        _mlp_step(torch.Generator().manual_seed(0))
    trace = hlo_stats.CostTrace()
    with trace:
        _mlp_step(torch.Generator().manual_seed(0))
    assert trace.flops == fc.get_total_flops() > 0
    assert trace.collectives == []


def test_bytes_and_peak_of_a_known_sequence():
    """Views move and allocate nothing; an op moves its operands and
    results; the peak counts live storages the trace allocated."""
    x = torch.ones(1000)  # an argument: allocated before
    trace = hlo_stats.CostTrace()
    with trace:
        y = x * 2  # reads 4000 B, writes 4000
        z = y.view(10, 100)  # a view: nothing
        w = z + 1  # reads 4000, writes 4000: peak 8000
        del y, z
        v = w.sum()  # reads 4000, writes 4
        w.mul_(3)  # in place: reads and writes w, allocates nothing
    assert trace.bytes_accessed == 8000 + 8000 + 4004 + 8000
    assert trace.bytes_written == 4000 + 4000 + 4 + 4000
    assert trace.peak == 8000
    assert trace.live == 4004
    summary = hlo_stats.cost_summary(trace, {"x": x}, (w, v, x))
    assert summary["argument_size_in_bytes"] == 4000
    assert summary["output_size_in_bytes"] == 4000 + 4 + 4000
    assert summary["alias_size_in_bytes"] == 4000
    assert summary["temp_size_in_bytes"] == 8000
    assert set(summary) >= {
        "flops", "bytes_accessed", "argument_size_in_bytes",
        "output_size_in_bytes", "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes"}
