#!/usr/bin/env bash
# Training across processes on one node, one process per card: the port's
# counterpart of scripts/run_train.sh. torchrun (part of torch) starts the
# processes and hands each RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
# MASTER_PORT; the train CLI joins them into one process group
# (unet_bssfp_tpu_torch/parallel/distributed.py): NCCL with a card per
# process, gloo on the CPU or where processes share a card. Every process
# loads only its stride-slice of the sample lists (DataConfig.process_split)
# and batch_size is per process; process 0 writes the logs and checkpoints.
#
# Usage:
#   scripts/torch_port_run_train.sh BIDS_DIR [train args...]
# Env:
#   NPROC   processes (default: the cards nvidia-smi lists; without a card,
#           and without DEVICE=cpu, the script stops)
#   DEVICE  cpu: NPROC processes on the CPU (default 2); cuda:N: NPROC
#           processes sharing card N; unset: cuda:LOCAL_RANK for each
#   CONFIG  JSON config path (optional)
set -euo pipefail

BIDS_DIR=${1:?usage: torch_port_run_train.sh BIDS_DIR [args...]}
shift || true
REPO=$(cd "$(dirname "$0")/.." && pwd)
ARGS=("$BIDS_DIR" "$@")
[ -n "${CONFIG:-}" ] && ARGS+=(--config "$CONFIG")

if [ -n "${DEVICE:-}" ]; then
  ARGS+=(--device "$DEVICE")
  [ "$DEVICE" = cpu ] && NPROC=${NPROC:-2}
fi
if [ -z "${NPROC:-}" ]; then
  if ! NPROC=$(nvidia-smi -L 2>/dev/null | grep -c '^GPU'); then
    echo "torch_port_run_train.sh: no card visible; set DEVICE=cpu to train on the CPU" >&2
    exit 1
  fi
fi

export OMP_NUM_THREADS=1   # host threads belong to the input pipeline
# No cd: a relative BIDS_DIR must resolve against the caller's cwd.
PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}" exec python3 -m torch.distributed.run \
  --standalone --nproc-per-node "$NPROC" -m unet_bssfp_tpu_torch.train "${ARGS[@]}"
