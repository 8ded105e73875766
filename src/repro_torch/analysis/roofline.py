"""Roofline table builder: reads the dry run's records -> markdown (port of
``repro/analysis/roofline.py``: the same table, notes and summary, so
that either package's records read the same).

Per (arch x shape) single-pod cell: the three roofline terms (seconds),
the dominant bottleneck, MODEL_FLOPS/HLO_FLOPS (useful-work ratio), a
roofline fraction (compute term / max term — how close to compute-bound the
cell is), and a one-line "what would move the dominant term" note.

``python -m repro_torch.analysis.roofline [--dir experiments/dryrun]``
prints the markdown table of the cells.
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load_cells(dir_: str, mesh: str = "single"):
    cells = []
    for path in sorted(glob.glob(os.path.join(dir_, f"*_{mesh}.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def advice(rec) -> str:
    r = rec.get("roofline")
    if not r:
        return ""
    dom = r["dominant"]
    mode = rec["mode"]
    arch = rec["arch"]
    if dom == "collective_s":
        cols = rec.get("collectives", {})
        big = max((k for k in cols if k != "total_wire_bytes"),
                  key=lambda k: cols[k]["bytes"], default="?")
        return (f"dominated by {big}: reshard to cut cross-shard traffic "
                f"(grad reduce-scatter / activation resharding)")
    if dom == "memory_s":
        if mode == "decode":
            return ("KV/state streaming bound: inherent for decode; "
                    "grow batch or quantize cache")
        if rec.get("mf_ratio", 1) < 0.5:
            return ("remat recompute + fp32 intermediates inflate HBM "
                    "traffic; relax remat policy or fuse")
        return "activation traffic bound: bigger per-chip tile / fusion"
    return "compute bound: already near the right wall; raise MXU utilization via layout"


def frac(rec) -> float:
    r = rec.get("roofline")
    if not r:
        return 0.0
    total = max(r["compute_s"], r["memory_s"], r["collective_s"])
    return r["compute_s"] / total if total else 0.0


def markdown_table(cells) -> str:
    head = ("| arch | shape | status | compute (ms) | memory (ms) | "
            "collective (ms) | dominant | MF ratio | roofline frac | note |\n"
            "|---|---|---|---|---|---|---|---|---|---|")
    rows = [head]
    for rec in cells:
        if rec["status"] == "skipped":
            rows.append(f"| {rec['arch']} | {rec['shape']} | skipped | - | -"
                        f" | - | - | - | - | {rec['reason'][:60]} |")
            continue
        if rec["status"] != "ok" or "roofline" not in rec:
            rows.append(f"| {rec['arch']} | {rec['shape']} | "
                        f"{rec['status']} | | | | | | | |")
            continue
        r = rec["roofline"]
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | ok "
            f"| {r['compute_s']*1e3:.1f} | {r['memory_s']*1e3:.1f} "
            f"| {r['collective_s']*1e3:.1f} | {r['dominant'][:-2]} "
            f"| {rec.get('mf_ratio', 0):.2f} | {frac(rec):.2f} "
            f"| {advice(rec)[:80]} |")
    return "\n".join(rows)


def summary(cells) -> dict:
    ok = [c for c in cells if c["status"] == "ok" and "roofline" in c]
    if not ok:
        return {}
    worst = min(ok, key=frac)
    coll = max(ok, key=lambda c: c["roofline"]["collective_s"])
    return {"worst_fraction": (worst["arch"], worst["shape"], frac(worst)),
            "most_collective": (coll["arch"], coll["shape"],
                                coll["roofline"]["collective_s"])}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args()
    cells = load_cells(args.dir, args.mesh)
    print(markdown_table(cells))
    s = summary(cells)
    if s:
        print(f"\nworst roofline fraction: {s['worst_fraction']}")
        print(f"most collective-bound:   {s['most_collective']}")


if __name__ == "__main__":
    main()
