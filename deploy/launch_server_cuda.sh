#!/usr/bin/env bash
# CUDA serving launch of the PyTorch port (dots_ocr_tpu_torch) on one GPU.
# Usage: ./deploy/launch_server_cuda.sh [WEIGHTS_DIR] [PORT]
#
# Defaults come from deploy/shipping.env, every key of it: the geometry,
# the quantization, speculation, the vision policy, WARMUP (full: capture
# every decode graph before binding; background: bind at once and warm on
# idle engine ticks) and COMPILE_CACHE (where the CUDA kernels are built and
# found; a second start loads them without nvcc). Any variable already set
# in the environment overrides the file (e.g. `WARMUP=background
# ./deploy/launch_server_cuda.sh`, `KV_DTYPE=int8` for the long-context
# capacity envelope). TENSOR_PARALLEL_SIZE=N serves over N ranks, and
# TP_BACKEND picks their collectives: nccl (default; one GPU a rank) or gloo
# (every rank on the one GPU).
set -euo pipefail

HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"

# Apply shipping.env as *defaults*: real env wins.
while IFS='=' read -r k v; do
  [[ -z "$k" || "$k" == \#* ]] && continue
  if [[ -z "${!k+x}" ]]; then
    printf -v "$k" '%s' "$v"
  fi
done < "$HERE/shipping.env"

WEIGHTS="${1:-./weights/DotsOCR}"
PORT="${2:-8000}"

# Relative cache paths resolve against the repo root, not the caller CWD.
if [[ -n "${COMPILE_CACHE:-}" && "${COMPILE_CACHE}" != /* ]]; then
  COMPILE_CACHE="$HERE/../${COMPILE_CACHE}"
fi

EXTRA=()
[[ -n "${QUANTIZE:-}" ]] && EXTRA+=(--quantize "$QUANTIZE")
[[ -n "${WARMUP:-}" ]] && EXTRA+=(--warmup "$WARMUP")
[[ -n "${COMPILE_CACHE:-}" ]] && EXTRA+=(--compile-cache "$COMPILE_CACHE")
[[ -n "${VISION_ATTN:-}" ]] && EXTRA+=(--vision-attn "$VISION_ATTN")
[[ -n "${VISION_WINDOW:-}" ]] && EXTRA+=(--vision-window-patches "$VISION_WINDOW")
[[ -n "${VISION_FULL_LAYERS:-}" ]] && EXTRA+=(--vision-full-layers "$VISION_FULL_LAYERS")
[[ -n "${TENSOR_PARALLEL_SIZE:-}" ]] && EXTRA+=(--tensor-parallel-size "$TENSOR_PARALLEL_SIZE")
[[ -n "${TP_BACKEND:-}" ]] && EXTRA+=(--tp-backend "$TP_BACKEND")

exec python -m dots_ocr_tpu_torch.serve.server \
  --platform cuda \
  --weights "$WEIGHTS" \
  --engine continuous \
  --num-pages "${NUM_PAGES}" \
  --page-size "${PAGE_SIZE}" \
  --kv-cache-dtype "${KV_DTYPE}" \
  --max-slots "${MAX_SLOTS}" \
  --max-seq-tokens "${MAX_SEQ_TOKENS}" \
  --steps-per-sync "${STEPS_PER_SYNC}" \
  --prefill-chunk-tokens "${PREFILL_CHUNK}" \
  --speculate-k "${SPECULATE_K}" \
  ${EXTRA[@]+"${EXTRA[@]}"} \
  --port "$PORT"
