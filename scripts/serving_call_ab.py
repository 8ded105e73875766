#!/usr/bin/env python3
"""Time K6 (``decode_attention_cuda``) at the serving loop's own call in
one or more checkouts of this repository, on one CUDA card.

    python3 scripts/serving_call_ab.py OLD_TREE NEW_TREE NEW_TREE OLD_TREE

Each argument is the root of a checkout (for example the parent commit
unpacked with ``git archive``); each runs in a fresh process, in the order
given, so two commits alternate on the same card.  The call is
launch/serve.py's at its defaults: 16 prompts of 16 tokens, 8 generated,
a cache of 25 positions of which 24 are valid, olmo-1b's 16 heads of 128,
bf16.  Per tree it prints the mean and median over 400 calls of the time
between CUDA events around one call (the wrapper's host work inside, as
chip_smoke.py's ``time_ms`` takes it) and the host time of one call (400
calls enqueued back to back).  It imports nothing of JAX.
"""

import subprocess
import sys
import time
from pathlib import Path

CALLS = 400


def measure(root: Path):
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import decode_attention as da
    if not torch.cuda.is_available():
        raise SystemExit("serving_call_ab: needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((16, 1, 16, 128), generator=g, device="cuda").bfloat16()
    kc, vc = (torch.randn((16, 25, 16, 128), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    call = lambda: da.decode_attention_cuda(q, kc, vc, 24)
    for _ in range(50):
        call()
    torch.cuda.synchronize()
    ms = []
    for _ in range(CALLS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        call()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    ms.sort()
    t = time.perf_counter()
    for _ in range(CALLS):
        call()
    host_us = 1e6 * (time.perf_counter() - t) / CALLS
    torch.cuda.synchronize()
    print(f"{root}: per call mean {sum(ms) / CALLS:.4f} ms, median "
          f"{ms[CALLS // 2]:.4f} ms; host {host_us:.1f} us a call",
          flush=True)


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        measure(Path(sys.argv[2]).resolve())
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for tree in sys.argv[1:]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True,
                       timeout=300)


if __name__ == "__main__":
    main()
