"""The port's serving slice against the JAX package: the OnAlgo admission
controller slot by slot, the request cost model, the wave machinery, and
the whole OnAlgo-gated LM serving loop (``launch/serve.py``) printing the
reference's lines.  Bars: offload masks exactly equal, mu within
rtol=1e-5, atol=1e-6 (the reference's dual bar, tests/test_kernels.py).
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.core.onalgo import OnAlgoParams as RefParams
from repro.core.onalgo import StepRule as RefRule
from repro.core.state_space import StateSpace as RefSpace
from repro.launch import serve as ref_serve
from repro.serve import admission as ref_admission
from repro.serve import engine as ref_engine
from repro_torch.configs import get_config
from repro_torch.core.onalgo import OnAlgoParams, StepRule
from repro_torch.core.state_space import StateSpace
from repro_torch.launch import serve as port_serve
from repro_torch.serve import admission, engine

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _space(h_req, cls):
    return cls(o_levels=(0.03, 0.06, 0.09),
               h_levels=(0.8 * h_req, h_req, 1.2 * h_req),
               w_levels=tuple(np.linspace(0, 0.4, 8).tolist()))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_admission_matches_reference(use_kernel):
    """20 slots at N=32 of launch/serve.py's traffic, capacity at 0.3 of
    the always-offload load so mu moves; use_kernel=True runs K3 (its
    plain version on CPU tensors; the reference's Pallas kernel in
    interpret mode)."""
    N = 32
    cfg = get_config("olmo-1b").reduced()
    h_req = admission.flops_per_request(cfg, 16) + 8 * \
        admission.flops_per_request(cfg, 1, "decode")
    H = 0.3 * N * h_req
    B = np.full(N, 0.06, np.float32)
    ref = ref_admission.AdmissionController(
        _space(h_req, RefSpace), RefParams(B=B, H=np.float32(H)),
        RefRule.inv_sqrt(0.5), N, use_kernel=use_kernel)
    mine = admission.AdmissionController(
        _space(h_req, StateSpace),
        OnAlgoParams(B=torch.tensor(B), H=torch.tensor(np.float32(H))),
        StepRule.inv_sqrt(0.5), N, use_kernel=use_kernel, device="cpu")
    rng = np.random.default_rng(7)
    mus = []
    for _ in range(20):
        task = rng.random(N) < 0.7
        o = rng.choice([0.03, 0.06, 0.09], N)
        h = np.clip(rng.normal(h_req, 0.1 * h_req, N), 0.5 * h_req, None)
        w = np.clip(rng.normal(0.15, 0.1, N), 0, 1)
        np.testing.assert_array_equal(mine.quantize(o, h, w, task),
                                      ref.quantize(o, h, w, task))
        np.testing.assert_array_equal(mine.admit(o, h, w, task),
                                      ref.admit(o, h, w, task))
        assert mine.mu == pytest.approx(ref.mu, rel=1e-5, abs=1e-6)
        np.testing.assert_allclose(mine.lam, ref.lam, rtol=1e-5, atol=1e-6)
        mus.append(mine.mu)
    assert max(mus) > 0  # the capacity price moved


def test_flops_per_request_matches_reference():
    for cfg, rcfg in ((get_config("olmo-1b"), ref_get_config("olmo-1b")),
                      (get_config("olmo-1b").reduced(),
                       ref_get_config("olmo-1b").reduced())):
        for mode, n in (("prefill", 16), ("decode", 1)):
            assert admission.flops_per_request(cfg, n, mode) == \
                ref_admission.flops_per_request(rcfg, n, mode)


def test_wave_machinery_matches_reference():
    seqs = [[1, 2, 3], [4], list(range(10))]
    for buckets in ((32, 8, 16), (5,)):
        mine, ref = (engine.WaveBuckets(buckets),
                     ref_engine.WaveBuckets(buckets))
        assert mine.buckets == ref.buckets
        for n in (0, 1, 5, 8, 9, 40):
            assert mine.bucket_len(n) == ref.bucket_len(n)
        np.testing.assert_array_equal(mine.pad_rows(seqs, 6, pad_id=9),
                                      ref.pad_rows(seqs, 6, pad_id=9))
    b, rb = engine.Batcher(max_batch=2), ref_engine.Batcher(max_batch=2)
    for s in seqs:
        b.submit(s)
        rb.submit(s)
    assert b.buckets == rb.buckets and b.bucket_len(40) == rb.bucket_len(40)
    while len(rb):
        assert b.next_wave() == rb.next_wave()
    assert b.next_wave() is None and len(b) == 0
    np.testing.assert_array_equal(engine.Batcher.pad_tokens(seqs, 4),
                                  ref_engine.Batcher.pad_tokens(seqs, 4))


ARGV = ["--arch", "olmo-1b", "--reduced", "--slots", "10", "--devices", "8"]


def test_serving_loop_matches_reference(monkeypatch, capsys):
    """The whole slice: the port's launch/serve loop (K3 and K6 routes,
    their plain versions on the CPU) and the reference's
    ``repro.launch.serve.main`` print the same served / offered / mu /
    queue / decode-calls / tokens lines."""
    monkeypatch.setattr(sys, "argv", ["serve", *ARGV])
    ref_serve.main()
    want = capsys.readouterr().out.splitlines()
    waves = []
    port_serve.main([*ARGV, "--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert got == want
    assert len(want) == 2 and "decode calls" in want[-1]

    args = port_serve.parse_args([*ARGV, "--device", "cpu"])
    cfg, params = port_serve.build_model(args)
    lines = []
    eng, ctrl, served, offered = port_serve.serve(
        args, cfg, params, on_wave=lambda t, o: waves.append((t, o)),
        log=lines.append)
    assert lines == want
    assert served == sum(len(t) for t, _ in waves) > 0
    assert eng.stats.decode_calls == len(waves) * args.gen_steps
    assert all(o.shape == (len(t), args.gen_steps) for t, o in waves)


def test_serve_entry_point_runs_without_jax():
    """``python -m repro_torch.launch.serve`` with jax and the reference
    blocked: the port's serving path needs neither."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            f"sys.argv = ['serve', *{ARGV!r}, '--slots', '5', "
            "'--device', 'cpu']\n"
            "runpy.run_module('repro_torch.launch.serve', "
            "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("[serve] done: served ")


def test_serving_entry_points_default_to_cuda(monkeypatch):
    """device=None (and the entry point's default --device) means the
    card; without one they raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("olmo-1b").reduced()
    space = _space(1e9, StateSpace)
    params = OnAlgoParams(B=torch.full((4,), 0.06), H=torch.tensor(1e9))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        admission.AdmissionController(space, params, StepRule.inv_sqrt(0.5),
                                      4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.ServingEngine(cfg, None, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_serve.build_model(port_serve.parse_args(["--reduced"]))
