"""The readings a cell's check limits are set from, at the cell's own size.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--kinds sound,control,state_unchanged,...] [--seconds 2] \
        [--out FILE]

Each reading is one run of the harness (``harness.run_cell``, untraced,
a window of ``--seconds``) on one seed, judged by the cell's own check
against its own limits, as a benchmark run is.  The kinds: ``sound``,
the program as it stands; ``control``, the plain reference in the
precision below the configuration's answering in the program's place
(``use_control``); and each fault of ``faults.FAULTS``, planted in the
program.  The sound readings set a limit's lower end, the control's its
upper end; the control and every fault have to come out not correct.
One JSON line a reading; not part of a benchmark run.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="sound,control")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--bench", default=str(ROOT / "BENCHMARK.json"))
    ap.add_argument("--traffic-dir", default=str(ROOT / "portbench"
                                                 / "traffic"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    from portbench import faults, harness

    out = open(args.out, "a") if args.out else None
    for kind in args.kinds.split(","):
        for seed in (int(s) for s in args.seeds.split(",") if s):
            rec = {"workload": args.workload, "kind": kind, "seed": seed}
            try:
                with (faults.planted(kind) if kind in faults.FAULTS
                      else contextlib.nullcontext()):
                    result, _ = harness.run_cell(
                        Path(args.bench), args.workload, seed, args.seconds,
                        False, args.device, t_start=time.perf_counter(),
                        root=ROOT, traffic_dir=Path(args.traffic_dir),
                        metric_dirs=[ROOT / "portbench" / "metrics"],
                        control=kind == "control")
            except Exception as exc:  # a run that crashes is not correct
                rec.update(correct=False, error=f"{type(exc).__name__}: "
                           f"{exc}")
            else:
                rec.update(correct=result["correct"],
                           attempted=result["attempted"],
                           **{k: c["value"]
                              for k, c in result["check"].items()},
                           limits={k: c["limit"]
                                   for k, c in result["check"].items()})
            line = json.dumps(rec)
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
