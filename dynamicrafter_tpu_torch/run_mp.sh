#!/bin/bash
# Data-parallel inference launcher of the PyTorch port (the JAX package's
# scripts/run_mp.sh with the same preset flags): one process per card, each
# sampling its slice of the prompts, no communication between them.
# usage: NUM_PROCESSES=2 PROCESS_ID=0 [COORDINATOR=host:port] \
#   bash dynamicrafter_tpu_torch/run_mp.sh <res> [ckpt_path] [prompt_dir] [extra flags]
# COORDINATOR is passed on for the JAX command line and has no effect. A smoke
# run without weights passes --random_init among the extra flags, which come
# last and override the preset's.
set -e
RES=${1:-512}
CKPT=${2:-checkpoints/dynamicrafter_${RES}_v1/model.ckpt}
PROMPTS=${3:-prompts/${RES}}
python -m dynamicrafter_tpu_torch.distributed_inference \
  --coordinator "${COORDINATOR}" --num_processes "${NUM_PROCESSES:-1}" \
  --process_id "${PROCESS_ID:-0}" \
  --config configs/inference_${RES}_v1.0.yaml \
  --ckpt_path "$CKPT" \
  --prompt_dir "$PROMPTS" --savedir results/mp_${RES} \
  --height 320 --width 512 --frame_stride 24 --ddim_steps 50 \
  --unconditional_guidance_scale 7.5 --text_input --bf16 \
  --timestep_spacing uniform_trailing --guidance_rescale 0.7 --perframe_ae "${@:4}"
