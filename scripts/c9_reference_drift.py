"""Do the JAX package's own engines part ways over long horizons as the
port's do?

For every kind of ``default_scenarios()`` (T=2000, N=8) and every catalog
entry, this runs the scan engine and the chunked engine of BOTH packages
on the CPU:

  * the reference: ``repro.scenarios.run_scenario(engine="scan")`` and
    ``engine="chunked", chunk=8`` (the Pallas rollout kernel in interpret
    mode, as ``tests/test_scenarios.py`` runs it);
  * the port: the same two engines on ``device="cpu"`` (the kernels'
    plain versions).

and counts, per package, the slots whose (N,) offload masks differ
between its two engines (the scan mask from ``collect_decisions``, the
chunked one as the rollout returns it before its accounting).  With
``--drift`` it also measures how two aggregate metrics drift between the
engines with the horizon (T = 240, 500, 1000, 2000): the offload share
of the tasks and the realized gain per task (reward / tasks, the fleet
tier's accuracy gain), as relative differences chunked vs scan.  With
``--flip LABEL:PKG`` (``PKG`` ref or port; repeatable; only these run) it
traces where that package's two engines part: the first slot whose
masks differ, with each flipping device's margin ``w - (lam*o + mu*h)``
(float64 of the float32 operands, in the dual space) under each
engine's duals there; the slot after which the engines' states (lam,
mu) first differ, bisected, and by how many float32 spacings; and the
first slot whose policy matrices (every state, realized or not) differ
under the two engines' duals, with the largest margin among the entries
that flip.  The chunked engine's states come from runs of ``chunk=1``
(no slot-step tail), checked bit for bit against ``chunk=8`` at the last
multiple of 8 before the first differing mask.

Run from the repo root (minutes; not part of the test suite):

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/c9_reference_drift.py \
        [--drift] [--only stationary,metro_daily] [--json out.json] \
        [--flip outage:port --flip heterogeneous:ref]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def _capture(fleet_mod, runner_mod):
    """Patch a package's fleet / runner so that both engines return the
    (T, N) offload mask as the series' ``offload_mask``: the scan engine
    through ``collect_decisions``, the chunked engine from its accounting
    post-pass (``_series_from_offloads``'s ``off``; T a multiple of the
    chunk, so no tail part)."""
    orig_series = fleet_mod._series_from_offloads
    orig_sim = runner_mod.simulate

    def series(j_seq, off, *a, **kw):
        # under the reference's jit ``off`` is a tracer: it leaves the
        # traced function as one more series key
        return dict(orig_series(j_seq, off, *a, **kw), offload_mask=off)

    def sim(*a, **kw):
        return orig_sim(*a, collect_decisions=True, **kw)

    fleet_mod._series_from_offloads = series
    runner_mod.simulate = sim


def _scenarios(T=None):
    """(label, reference spec-or-entry, port spec-or-entry) pairs; ``T``
    replaces every spec's horizon (the catalog's modifiers too)."""
    from repro.scenarios import catalog as rcat
    from repro.scenarios import default_scenarios as r_default
    from repro_torch.scenarios import catalog as pcat
    from repro_torch.scenarios import default_scenarios as p_default

    cut = (lambda s: s) if T is None else (
        lambda s: dataclasses.replace(s, T=T))
    out = [(s.kind, cut(s), cut(p)) for s, p in zip(r_default(),
                                                     p_default())]
    r_cat, p_cat = rcat.load_catalog(), pcat.load_catalog()
    for name in sorted(r_cat):
        re, pe = r_cat[name], p_cat[name]
        out.append((f"catalog {name}",
                    rcat.CatalogEntry(re.name, cut(re.base),
                                      tuple(cut(m) for m in re.modifiers)),
                    pcat.CatalogEntry(pe.name, cut(pe.base),
                                      tuple(cut(m) for m in pe.modifiers))))
    return out


def _compile(pkg, spec):
    if hasattr(spec, "modifiers"):
        return spec.compile() if pkg == "ref" else spec.compile(device="cpu")
    if pkg == "ref":
        from repro.scenarios import compile_scenario
        return compile_scenario(spec)
    from repro_torch.scenarios import compile_scenario
    return compile_scenario(spec, device="cpu")


def _metrics(series):
    tasks = max(float(np.sum(np.asarray(series["tasks"]))), 1.0)
    return {"offload_frac": float(np.sum(np.asarray(series["offloads"])))
            / tasks,
            "gain_per_task": float(np.sum(np.asarray(series["reward"])))
            / tasks}


def _engines(pkg):
    """(simulate, simulate_chunked, precondition_tables, StepRule, kw)
    of one package (the port's on the CPU)."""
    if pkg == "ref":
        from repro.core.fleet import simulate, simulate_chunked
        from repro.core.onalgo import StepRule, precondition_tables
        return simulate, simulate_chunked, precondition_tables, StepRule, {}
    from repro_torch.core.fleet import simulate, simulate_chunked
    from repro_torch.core.onalgo import StepRule, precondition_tables
    return (simulate, simulate_chunked, precondition_tables, StepRule,
            dict(device="cpu"))


def _np(x):
    return x.numpy() if hasattr(x, "numpy") and not isinstance(
        x, np.ndarray) else np.asarray(x)


def _assoc_at(topology, t):
    """Slot t's (N,) association of a topology (None without one)."""
    if topology is None or topology.K == 1:
        return None
    assoc = topology.assoc
    if not hasattr(assoc, "ndim"):
        assoc = assoc.slab(t, 1)
    assoc = _np(assoc)
    return assoc[t] if assoc.ndim == 2 and assoc.shape[0] > 1 else (
        assoc.reshape(-1, assoc.shape[-1])[-1])


def _margins(c, precond, t, lam, mu):
    """(N, M) float64 margins w - (lam*o + mu*h) of every state under
    duals (lam, mu) entering slot t, in the dual space; the policy offloads
    where the margin is positive and w > 0."""
    o_p, h_p = (_np(x).astype(np.float64) for x in precond(
        c.tables[0], c.tables[1], c.params)[:2])
    w = _np(c.tables[2]).astype(np.float64)
    lam = _np(lam).astype(np.float64)
    mu = _np(mu).astype(np.float64)
    assoc = _assoc_at(c.topology, t)
    mu_n = mu[assoc] if assoc is not None else mu.reshape(-1)[0]
    N = lam.shape[0]
    o_p, h_p, w = (np.broadcast_to(x, (N, x.shape[-1])) for x in
                   (o_p, h_p, w))
    return w - (lam[:, None] * o_p + np.asarray(mu_n).reshape(-1, 1) * h_p), w


def _ulps(a, b):
    """(largest |a - b| in float32 spacings, entries that differ)."""
    a, b = _np(a).astype(np.float32), _np(b).astype(np.float32)
    sp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    return float((np.abs(a.astype(np.float64) - b) / sp).max()), int(
        (a != b).sum())


def first_flip(pkg, spec):
    """Where ``pkg``'s scan and chunked engines part (see the module
    docstring): the first slot whose realized masks differ (None if
    none), with each flipping device's margin under either engine's
    duals; the slot after which the engines' states (lam, mu) first
    differ, bisected, and by how many float32 spacings (origin; None if
    they never do); and the first slot whose policy matrices (every
    state, not only the realized one) differ under the two engines'
    duals, searched in the five slots up to where the dual series first
    part by more than 1e-5, with the margins of the entries that flip
    (jump)."""
    simulate, chunked, precond, StepRule, kw = _engines(pkg)
    rule = StepRule.inv_sqrt(0.5)
    c = _compile(pkg, spec)
    ser_s = simulate(c.trace, c.tables, c.params, rule,
                     collect_decisions=True, topology=c.topology, **kw)[0]
    ser_k = chunked(c.trace, c.tables, c.params, rule, chunk=8,
                    topology=c.topology, **kw)[0]
    scan = _np(ser_s["offload_mask"]).astype(bool)
    chk = _np(ser_k["offload_mask"]).astype(bool)
    T = len(scan)
    slots = np.nonzero(np.any(scan != chk, axis=1))[0]
    t = int(slots[0]) if len(slots) else None
    cut = lambda n: dataclasses.replace(c.trace, j_idx=c.trace.j_idx[:n],
                                        d_local=c.trace.d_local[:n])

    def states(n):
        """Both engines' states after n >= 1 slots (the chunked one from
        chunk=1, so that no tail takes the slot step)."""
        return (simulate(cut(n), c.tables, c.params, rule,
                         topology=c.topology, **kw)[1],
                chunked(cut(n), c.tables, c.params, rule, chunk=1,
                        topology=c.topology, **kw)[1])

    def equal_after(n):
        a, b = states(n)
        return all(np.array_equal(_np(getattr(a, f)), _np(getattr(b, f)))
                   for f in ("lam", "mu"))

    out = {"slot": t, "T": T, "slots_differing": int(len(slots)),
           "chunk1_equals_chunk8_at": None, "devices": [], "origin": None,
           "jump": None}
    w = None
    if t is not None:
        t8 = t - t % 8
        if t8:
            a = states(t8)[1]
            b = chunked(cut(t8), c.tables, c.params, rule, chunk=8,
                        topology=c.topology, **kw)[1]
            if all(np.array_equal(_np(getattr(a, f)), _np(getattr(b, f)))
                   for f in ("lam", "mu")):
                out["chunk1_equals_chunk8_at"] = t8
        s_st, k_st = states(t)
        m_s, w = _margins(c, precond, t, s_st.lam, s_st.mu)
        m_k, _ = _margins(c, precond, t, k_st.lam, k_st.mu)
        j_row = _np(c.trace.j_idx[t])
        out["devices"] = [
            {"device": int(n), "j": int(j_row[n]), "w": float(w[n, j_row[n]]),
             "scan_offloads": bool(scan[t, n]),
             "scan_margin": float(m_s[n, j_row[n]]),
             "chunked_margin": float(m_k[n, j_row[n]])}
            for n in np.nonzero(scan[t] != chk[t])[0]]

    # the states: equal after 0 slots; bisect for the first slot after
    # which they differ
    hi = t if t is not None else T
    if t is None and equal_after(T):
        return out
    lo = 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if equal_after(mid) else (lo, mid)
    after = states(hi)
    (lam_u, lam_n), (mu_u, mu_n) = (_ulps(getattr(after[0], f),
                                          getattr(after[1], f))
                                    for f in ("lam", "mu"))
    out["origin"] = {"slot": hi - 1, "lam_ulps_max": lam_u,
                     "lam_entries": lam_n, "mu_ulps_max": mu_u,
                     "mu_entries": mu_n}

    # the first policy flip, near where the dual series part by > 1e-5
    mu_s, mu_k = (_np(x["mu"]).reshape(T, -1) for x in (ser_s, ser_k))
    ln_s, ln_k = (_np(x["lam_norm"]).reshape(-1) for x in (ser_s, ser_k))
    big = ((np.abs(ln_s - ln_k) > 1e-5 * np.abs(ln_s))
           | np.any(np.abs(mu_s - mu_k)
                    > 1e-5 * max(float(np.abs(mu_s).max()), 1e-30), axis=1))
    if not big.any():
        return out
    t_j = int(np.argmax(big))
    out["jump"] = {"slot": None, "series_part_at": t_j}
    for u in range(max(t_j - 4, hi), t_j + 1):
        ent = states(u)
        ms, w = _margins(c, precond, u, ent[0].lam, ent[0].mu)
        mk, _ = _margins(c, precond, u, ent[1].lam, ent[1].mu)
        flip = (w > 0) & ((ms > 0) != (mk > 0))
        if flip.any():
            n, j = (int(x[0]) for x in np.nonzero(flip))
            out["jump"].update(
                slot=u, entries_flipped=int(flip.sum()),
                max_abs_margin=float(np.max(np.maximum(np.abs(ms[flip]),
                                                       np.abs(mk[flip])))),
                w_spacing=float(np.spacing(np.float32(w[n, j]))))
            break
    return out


def run_pair(pkg, spec):
    """Both engines of one package on one scenario: (differing mask
    slots, differing per-slot offload counts, scan metrics, chunked
    metrics, seconds of each engine)."""
    if pkg == "ref":
        from repro.core.onalgo import StepRule
        from repro.scenarios import run_scenario
        kw = {}
    else:
        from repro_torch.core.onalgo import StepRule
        from repro_torch.scenarios import run_scenario
        kw = dict(device="cpu")
    rule = StepRule.inv_sqrt(0.5)
    c = _compile(pkg, spec)
    t0 = time.perf_counter()
    s_scan = run_scenario(c, rule=rule, engine="scan", use_kernel=False,
                          **kw)[0]
    t1 = time.perf_counter()
    s_chk = run_scenario(c, rule=rule, engine="chunked", chunk=8, **kw)[0]
    t2 = time.perf_counter()
    m_scan = np.asarray(s_scan["offload_mask"], bool)
    m_chk = np.asarray(s_chk["offload_mask"], bool)
    mask_slots = int(np.any(m_scan != m_chk, axis=1).sum())
    off_a = np.asarray(s_scan["offloads"])
    off_b = np.asarray(s_chk["offloads"])
    count_slots = int((off_a != off_b).sum())
    return (mask_slots, count_slots, _metrics(s_scan), _metrics(s_chk),
            t1 - t0, t2 - t1, m_scan.shape)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--drift", action="store_true",
                   help="also the metrics' drift at T=240, 500, 1000, 2000")
    p.add_argument("--only", default="",
                   help="comma-separated labels (kinds or catalog names)")
    p.add_argument("--json", default="", help="write the rows here")
    p.add_argument("--flip", action="append", default=[],
                   help="LABEL:PKG (PKG ref or port): the first flip's "
                        "margins; only these run")
    args = p.parse_args(argv)

    from repro.core import fleet as rfleet
    from repro.scenarios import runner as rrunner
    from repro_torch.core import fleet as pfleet
    from repro_torch.scenarios import runner as prunner
    _capture(rfleet, rrunner)
    _capture(pfleet, prunner)
    only = {s for s in args.only.split(",") if s}
    keep = lambda label: not only or label.replace("catalog ", "") in only

    if args.flip:
        specs = {label: (rspec, pspec) for label, rspec, pspec
                 in _scenarios()}
        flips = []
        for item in args.flip:
            label, pkg = item.rsplit(":", 1)
            spec = specs[label if label in specs else f"catalog {label}"]
            res = first_flip(pkg, spec[0] if pkg == "ref" else spec[1])
            flips.append({"scenario": label, "package": pkg, "flip": res})
            if res["slot"] is None:
                print(f"{label} | {pkg}: the masks agree on all {res['T']} "
                      f"slots")
            else:
                print(f"{label} | {pkg}: first differing slot {res['slot']}"
                      f" of {res['T']} ({res['slots_differing']} differ); "
                      f"chunk=1 == chunk=8 at slot "
                      f"{res['chunk1_equals_chunk8_at']}")
            for d in res["devices"]:
                print(f"  device {d['device']} (state {d['j']}): w "
                      f"{d['w']:.9g}; scan offloads {d['scan_offloads']}; "
                      f"margin scan {d['scan_margin']:+.3e}, chunked "
                      f"{d['chunked_margin']:+.3e}", flush=True)
            o = res["origin"]
            if o is None:
                print(f"  the states agree bit for bit after all "
                      f"{res['T']} slots")
                continue
            print(f"  the states first part in slot {o['slot']} (equal "
                  f"entering it, so the same policy): after it lam differs "
                  f"at {o['lam_entries']} devices by at most "
                  f"{o['lam_ulps_max']:.3g} float32 spacings, mu at "
                  f"{o['mu_entries']} entries by at most "
                  f"{o['mu_ulps_max']:.3g}")
            jmp = res["jump"]
            if jmp is not None and jmp["slot"] is not None:
                print(f"  the dual series part by > 1e-5 at slot "
                      f"{jmp['series_part_at']}; the first policy flip "
                      f"before it, slot {jmp['slot']}: "
                      f"{jmp['entries_flipped']} entries, margins at most "
                      f"{jmp['max_abs_margin']:.3e} under either engine "
                      f"(float32 spacing at w {jmp['w_spacing']:.3e})",
                      flush=True)
            elif jmp is not None:
                print(f"  the dual series part by > 1e-5 at slot "
                      f"{jmp['series_part_at']}; no policy flip in the 5 "
                      f"slots before it", flush=True)
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"flips": flips}, f, indent=1)
        return flips

    rows = []
    print("scenario | T | N | reference: mask slots (count slots) | "
          "port: mask slots (count slots) | ref s scan/chunked")
    for label, rspec, pspec in _scenarios():
        if not keep(label):
            continue
        r = run_pair("ref", rspec)
        q = run_pair("port", pspec)
        T, N = q[6]
        rows.append({"scenario": label, "T": T, "N": N,
                     "ref_mask_slots": r[0], "ref_count_slots": r[1],
                     "port_mask_slots": q[0], "port_count_slots": q[1]})
        print(f"{label} | {T} | {N} | {r[0]} ({r[1]}) | {q[0]} ({q[1]}) | "
              f"{r[4]:.1f}/{r[5]:.1f}", flush=True)

    drift = []
    if args.drift:
        print("\nscenario | T | package | offload_frac scan, chunked, "
              "rel diff | gain_per_task scan, chunked, rel diff | mask slots")
        for T in (240, 500, 1000, 2000):
            for label, rspec, pspec in _scenarios(T):
                if not keep(label):
                    continue
                for pkg, spec in (("ref", rspec), ("port", pspec)):
                    ms, _, a, b = run_pair(pkg, spec)[:4]
                    row = {"scenario": label, "T": T, "package": pkg,
                           "mask_slots": ms}
                    for key in ("offload_frac", "gain_per_task"):
                        rel = (b[key] - a[key]) / max(abs(a[key]), 1e-12)
                        row[key] = (a[key], b[key], rel)
                    drift.append(row)
                    print(f"{label} | {T} | {pkg} | "
                          f"{a['offload_frac']:.6f}, {b['offload_frac']:.6f},"
                          f" {row['offload_frac'][2]:+.3e} | "
                          f"{a['gain_per_task']:.6f}, "
                          f"{b['gain_per_task']:.6f}, "
                          f"{row['gain_per_task'][2]:+.3e} | {ms}",
                          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"counts": rows, "drift": drift}, f, indent=1)
    return rows, drift


if __name__ == "__main__":
    main()
