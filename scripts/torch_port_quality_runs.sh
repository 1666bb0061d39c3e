#!/bin/bash
# The port's quality runs on one card, in one go: the two linked cohorts
# written in two processes (12 subjects at offset 0, 5 at offset 10, both at
# (96, 128, 128)), then the two-cohort A/B, the quality record with its
# judged artifact, the oracle and the single-cohort A/B, each with its wall
# seconds. The records go where the scripts write them (CONVERGENCE_TORCH.json,
# QUALITY_TORCH.json, quality_torch/); the logs, the fixtures and the runs'
# work to OUT (default perf_out/quality_runs, git-ignored). Run from the
# repository's root:
#   bash scripts/torch_port_quality_runs.sh [OUT]
set -u
OUT=${1:-perf_out/quality_runs}
mkdir -p "$OUT/tmp"
export TMPDIR=$PWD/$OUT/tmp
export CONVBENCH_DATA=$TMPDIR/cohort12 CONVBENCH_DATA_B=$TMPDIR/cohort5
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$OUT/card.txt"
python -c "import sys, torch; print(sys.version, torch.__version__, torch.version.cuda)" | tee -a "$OUT/card.txt"
t0=$(date +%s)
fixture() {  # cache subjects seed offset
  python -c "
import sys, time; sys.path.insert(0, '.')
from scripts import torch_port_quality_record as qr
t = time.perf_counter(); qr.cached_fixture('$1', $2, qr.FULL_VOLUME, seed=$3, link_tag_offset=$4)
print('cohort of $2', time.perf_counter() - t)"
}
fixture "$CONVBENCH_DATA" 12 0 0 > "$OUT/fixture12.log" 2>&1 &
p12=$!
fixture "$CONVBENCH_DATA_B" 5 1 10 > "$OUT/fixture5.log" 2>&1
wait $p12
echo "fixtures done in $(( $(date +%s) - t0 )) s"; cat "$OUT"/fixture*.log
run() {
  local name=$1; shift
  local s=$(date +%s)
  "$@" > "$OUT/$name.log" 2>&1
  echo "$name rc=$? $(( $(date +%s) - s )) s"
  tail -3 "$OUT/$name.log"
}
run ab_two_cohort python scripts/torch_port_multistage_bench.py --two-cohort
run quality_record python scripts/torch_port_quality_record.py --max-epochs 120
run oracle python scripts/torch_port_oracle_ceiling.py --repeats 4
run ab_single python scripts/torch_port_multistage_bench.py
rm -rf "$OUT/tmp"
echo "all done in $(( $(date +%s) - t0 )) s"
