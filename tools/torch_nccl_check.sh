#!/bin/bash
# The mesh's NCCL path (parallel/mesh.py, Mesh.native): fine-tunes of
# llama-3.2-1b at 8 x 2048 through torchrun on 4 ranks, each on a GPU of
# its own, beside one rank's run of the same seed (its first loss is the
# one the meshes must report). Needs 4 GPUs on one host:
#
#     bash tools/torch_nccl_check.sh [RUN ...]
#
# RUN names the mesh runs to make (fsdp4, fsdp2_sp2, dp2_sp2_ulysses; all
# three, and the one-rank run, when none is named). Logs go to
# $LOG_DIR/nccl_<run>.log (default build/nccl_check); each run's first
# lines, steps and summary are printed.
cd "$(dirname "$0")/.."
LOG_DIR=${LOG_DIR:-build/nccl_check}
mkdir -p "$LOG_DIR"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.nccl.version())'
python -c "from dstack_tpu_torch.ops import cuda_build; print(cuda_build.build_all())"
FT="-m dstack_tpu_torch.train.finetune --model llama-3.2-1b --full --log-every 1"
if [ $# -eq 0 ]; then
  python $FT --steps 1 --out build/nccl_one > $LOG_DIR/nccl_one.log 2>&1
  echo "one rc=$?"
  grep '"event": "summary"' $LOG_DIR/nccl_one.log | cut -c1-400
  rm -rf build/nccl_one
fi
status=0
for run in "fsdp4:" "fsdp2_sp2:--fsdp 2 --sp 2" "dp2_sp2_ulysses:--dp 2 --fsdp 1 --sp 2 --seq-parallel ulysses"; do
  name=${run%%:*}; flags=${run#*:}
  if [ $# -gt 0 ] && ! printf '%s\n' "$@" | grep -qx "$name"; then continue; fi
  torchrun --nproc-per-node 4 --master-port 29517 $FT --steps 3 --out build/nccl_$name $flags \
    > $LOG_DIR/nccl_$name.log 2>&1
  rc=$?
  echo "$name rc=$rc"
  [ $rc -eq 0 ] || status=1
  head -2 $LOG_DIR/nccl_$name.log | cut -c1-400
  grep -E '^step ' $LOG_DIR/nccl_$name.log | cut -c1-300
  grep '"event": "summary"' $LOG_DIR/nccl_$name.log | cut -c1-1500
  rm -rf build/nccl_$name
done
exit $status
