#!/bin/bash
# SDS guidance preset launcher of the PyTorch port (the JAX package's
# scripts/run_guidance.sh with the same flags).
# usage: bash dynamicrafter_tpu_torch/run_guidance.sh <256|512|1024> [ckpt_path] [prompt_dir] [extra flags]
# A smoke run without weights passes --random_init among the extra flags (a
# later flag overrides the preset's, e.g. --num_steps 20).
set -e
RES=${1:-256}
CKPT=${2:-checkpoints/dynamicrafter_${RES}_v1/model.ckpt}
PROMPTS=${3:-prompts/${RES}}
case $RES in
  256)  H=256; W=256;  FS=3;;
  512)  H=320; W=512;  FS=24;;
  1024) H=576; W=1024; FS=10;;
  *) echo "unknown resolution $RES"; exit 1;;
esac
python -m dynamicrafter_tpu_torch.generate_guidance \
  --config configs/inference_${RES}_v1.0.yaml \
  --ckpt_path "$CKPT" --prompt_dir "$PROMPTS" \
  --savedir results_guidance/dynamicrafter_${RES} \
  --height $H --width $W --frame_stride $FS \
  --num_steps 1000 --lr 0.01 --cfg_scale 7.5 --weight_type t \
  --seed 123 --bf16 \
  --debug_dir results_guidance/dynamicrafter_${RES}/debug "${@:4}"
