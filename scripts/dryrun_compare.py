"""Count the cells of a directory of dry-run records (``launch.dryrun
--out``), and compare it with a second one, cell by cell.

Each cell's record in ``a`` is held against the record of the same file
name in ``b``: the status, and for a cell ok in both every count the
record holds (FLOPs, bytes accessed, argument, output, temporary and
alias bytes, collectives, the roofline terms); the trace's seconds are
not compared.  Prints the status counts of each mesh in each directory,
the cells whose records differ, and the range of trace seconds.

Usage:
  python scripts/dryrun_compare.py DIR_A [DIR_B]

Exits 1 if a cell of DIR_A errored or, given DIR_B, a record differs.
"""

import json
import sys
from collections import Counter
from pathlib import Path

TIMING = ("compile_s", "probe_s", "traceback")


def load(d):
    return {p.name: json.loads(p.read_text())
            for p in sorted(Path(d).glob("*.json"))}


def summary(recs, name):
    for tag in ("single", "multi"):
        cells = [r for k, r in recs.items() if k.endswith(f"_{tag}.json")]
        if not cells:
            continue
        st = Counter(r["status"] for r in cells)
        secs = [r["compile_s"] for r in cells if r["status"] == "ok"]
        print(f"{name} {tag}: {st['ok']} ok, {st['skipped']} skipped, "
              f"{st['error']} errors of {len(cells)} cells; trace seconds "
              f"{min(secs, default=0)}-{max(secs, default=0)}")
        for r in cells:
            if r["status"] == "error":
                print(f"  error {r['arch']} x {r['shape']}: {r['error']}")


def main(a, b=None):
    ra = load(a)
    summary(ra, a)
    errors = any(r["status"] == "error" for r in ra.values())
    if b is None:
        return int(errors)
    rb = load(b)
    summary(rb, b)
    same, differ, only = 0, [], sorted(set(ra) ^ set(rb))
    for k in sorted(set(ra) & set(rb)):
        x, y = ra[k], rb[k]
        if x["status"] != "ok" or y["status"] != "ok":
            if x["status"] != y["status"]:
                differ.append((k, "status", x["status"], y["status"]))
            continue
        keys = (set(x) | set(y)) - set(TIMING)
        diff = [key for key in sorted(keys) if x.get(key) != y.get(key)]
        if diff:
            differ.append((k, diff, *[{d: r.get(d) for d in diff}
                                      for r in (x, y)]))
        else:
            same += 1
    print(f"{same} cells ok in both with equal records; {len(differ)} "
          f"differ; {len(only)} in one directory only")
    for d in differ:
        print("  differs:", d)
    for k in only:
        print("  only in one:", k)
    return int(errors or bool(differ))


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:3]))
