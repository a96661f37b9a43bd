#!/usr/bin/env bash
# Multi-process run of the PyTorch/CUDA port (examples/multihost.sh on
# python -m fxtpu_torch): the SAME command once per process, here 2 local
# processes with 4 shards each, joined over torch.distributed (gloo).
# Each process feeds only the sample span its shards own
# (fxtpu_torch.parallel.ingest.local_sample_span); process 0 writes the
# CSV (vis_mh.csv in the current directory, or $FXTPU_OUT).  The shards
# are on --device (cuda, the default, or cpu); on several hosts, give
# --coordinator host0's address and --backend nccl where every process
# owns a card of its own.
set -e
COORD=${FXTPU_COORD:-127.0.0.1:9731}
OUT=${FXTPU_OUT:-vis_mh.csv}
REC=${1:?usage: multihost_torch.sh recording.npy [extra flags...]}
shift || true
ARGS="--source replay --replay_file $REC --num_samp 16384 --resolution 256 \
      --mode spectrum --omit_plot --no_keyboard --output $OUT \
      --num_processes 2 --coordinator $COORD --local_devices 4 \
      --backend gloo $*"
python -m fxtpu_torch $ARGS --process_id 1 &
RANK1=$!
# if rank 0 dies, don't orphan rank 1 holding the coordinator port
trap 'kill $RANK1 2>/dev/null' EXIT
python -m fxtpu_torch $ARGS --process_id 0
# bare `wait` always exits 0 — wait on the PID so a rank-1 failure fails
# the script instead of printing a success line over a partial product
wait $RANK1
trap - EXIT
echo "product: $OUT"
