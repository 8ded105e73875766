"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout.  Exits non-zero, printing no result, where
there is no CUDA card, too few for the cell, or no program beside the
benchmark (``src/repro_torch``).  The last line of standard output is
one JSON object; the numbers the check compared, each beside its limit,
are the last lines of standard error.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache the program or torch may write stays in the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("portbench: no program (src/repro_torch) in this checkout",
              file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    from portbench import harness

    result, lines = harness.run_cell(
        ROOT / "BENCHMARK.json", args.workload, args.seed, args.seconds,
        bool(args.trace), "cuda", t_start=T_START, root=ROOT,
        traffic_dir=ROOT / "portbench" / "traffic",
        metric_dirs=[ROOT / "portbench" / "metrics"])
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
