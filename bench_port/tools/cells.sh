#!/usr/bin/env bash
# Run cells of the benchmark one after another on this machine's card.
#   bench_port/tools/cells.sh <out-dir> <cell>:<seed>:<trace>:<seconds> ...
# Each run's result line goes to <out-dir>/results.jsonl (with the cell,
# seed, trace, exit code and wall seconds), its standard error to
# <out-dir>/<cell>.<seed>.<trace>.err.
set -u
out="$1"; shift
mkdir -p "$out"
for item in "$@"; do
  IFS=: read -r cell seed trace secs <<< "$item"
  t0=$(date +%s.%N)
  line=$(timeout -k 10 400 python3 bench_port/run.py --workload "$cell" \
    --seed "$seed" --seconds "$secs" --trace "$trace" \
    2> "$out/$cell.$seed.$trace.err" | tail -n 1)
  rc=${PIPESTATUS[0]}
  t1=$(date +%s.%N)
  wall=$(python3 -c "print(round($t1 - $t0, 3))")
  echo "{\"cell\": \"$cell\", \"seed\": $seed, \"trace\": $trace, \"rc\": $rc, \"wall_s\": $wall, \"line\": ${line:-null}}" >> "$out/results.jsonl"
  echo "$cell seed $seed trace $trace rc $rc wall $wall"
  tail -n 6 "$out/$cell.$seed.$trace.err"
done
