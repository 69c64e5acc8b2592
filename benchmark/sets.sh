#!/bin/bash
# The runs that a cell's bounds are set from, on the card:
#
#   bash benchmark/sets.sh <output dir> <seed base> <cell> [<cell> ...]
#
# For each cell: one first run (it builds), then six runs on seeds base+1 ..
# base+6 (set A), the same six seeds again (set B), then three traced runs
# on base+7 .. base+9, each at BENCHMARK.json's run_seconds. Every run's
# line and standard error go to <output dir>/f_<cell>_<set>_<seed>.{out,err};
# give a directory that .gitignore lists.
set -u
dir=$1; base=$2; shift 2
seconds=$(python3 -c 'import json; print(json.load(open("BENCHMARK.json"))["run_seconds"])')
mkdir -p "$dir"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
for cell in "$@"; do
  run() {
    local out=$dir/f_${cell}_$3_$1 t0=$(date +%s)
    python3 benchmark/run.py --workload "$cell" --seed "$1" --seconds "$seconds" --trace "$2" \
      > "$out.out" 2> "$out.err"
    echo "rc=$? $cell $3 seed=$1 trace=$2 wall=$(( $(date +%s) - t0 ))s $(grep -h 'set-up\|^calls' "$out.err" | tr '\n' ' ')"
  }
  run $((base + 99)) 0 first
  for set in A B; do for k in 1 2 3 4 5 6; do run $((base + k)) 0 $set; done; done
  for k in 7 8 9; do run $((base + k)) 1 T; done
done
