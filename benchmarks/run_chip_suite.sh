#!/bin/sh
# Serial chip-measurement suite: run every benchmark that feeds the
# committed JSON artifacts, one process at a time (a JAX process reserves
# most of the GPU's memory, so a second one on the card fails, and
# parallel runs would contend and time compiles instead of steady state).  Each step appends to
# benchmarks/chip_suite.log; rerunning is idempotent (every script
# rewrites its own artifact).
#
# Usage: sh benchmarks/run_chip_suite.sh [quick]
set -x
cd "$(dirname "$0")/.."
LOG=benchmarks/chip_suite.log
: > "$LOG"

probe() {
    # the suite measures the GPU only: refuse to start without one
    timeout 120 python -c "from echoseal_tpu.utils.device import gpu_info; print(gpu_info())" >> "$LOG" 2>&1
}
probe || { echo "no GPU visible to JAX -- aborting suite" | tee -a "$LOG"; exit 1; }

timeout 3600 python benchmarks/scl_sweep.py --skip-reference \
    --out benchmarks/scl_sweep_serving.json >> "$LOG" 2>&1
timeout 5400 python benchmarks/impaired_bench.py --batch 1024 \
    --out benchmarks/impaired_1k.json >> "$LOG" 2>&1
timeout 3600 python benchmarks/timescale_attrib.py --batch 1024 \
    --out benchmarks/timescale_attrib.json >> "$LOG" 2>&1
timeout 5400 python benchmarks/ladder_profile.py \
    --out benchmarks/ladder_profile.json >> "$LOG" 2>&1
timeout 2400 python benchmarks/serving_latency.py >> "$LOG" 2>&1
timeout 7200 python benchmarks/codec_envelope.py >> "$LOG" 2>&1
timeout 4800 python bench.py >> "$LOG" 2>&1
echo SUITE_DONE | tee -a "$LOG"
