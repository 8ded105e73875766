#!/usr/bin/env bash
# The dry run's whole sweep, `python -m repro_torch.launch.dryrun --all
# --both-meshes` split into one process per (arch, mesh) so that it fits a
# call's time limit: JOBS processes at a time (default 8), each tracing the
# arch's four shapes on the fake 16x16 or 2x16x16 mesh of DEVICE (default
# cuda), records to OUT.  Prints each process's exit code and seconds, the
# cells' lines, and the status counts of each mesh; exits 1 if a cell
# errored.  On the card (~5 min on 8 cores):
#   bash scripts/dryrun_sweep.sh experiments/dryrun
# then, against another tree's records:
#   python scripts/dryrun_compare.py experiments/dryrun OTHER_DIR
set -u
OUT=${1:?usage: dryrun_sweep.sh OUT [JOBS] [DEVICE]}
JOBS=${2:-8}
DEVICE=${3:-cuda}
cd "$(dirname "$0")/.."
export PYTHONPATH=src
rm -rf "$OUT" && mkdir -p "$OUT"
start=$(date +%s)
python -c 'from repro_torch.configs import list_archs; print("\n".join(list_archs()))' |
  while read -r arch; do echo "$arch single"; echo "$arch multi"; done |
  xargs -P "$JOBS" -L 1 bash -c '
    flag=""; [ "$1" = multi ] && flag=--multi-pod
    t0=$(date +%s)
    python -m repro_torch.launch.dryrun --arch "$0" $flag --device "'"$DEVICE"'" \
      --out "'"$OUT"'" > "'"$OUT"'/$0_$1.log" 2>&1
    echo "$0 $1: exit $? in $(( $(date +%s) - t0 )) s"'
echo "sweep wall $(( $(date +%s) - start )) s"
grep -h "^\[dryrun\]" "$OUT"/*.log | grep -v "done:"
python scripts/dryrun_compare.py "$OUT"
