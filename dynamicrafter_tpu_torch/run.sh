#!/bin/bash
# Resolution-preset inference launcher of the PyTorch port (the JAX package's
# scripts/run.sh with the same flags).
# usage: bash dynamicrafter_tpu_torch/run.sh <256|512|1024> [ckpt_path] [prompt_dir] [extra flags]
# A missing checkpoint is an error; a smoke run without weights passes
# --random_init among the extra flags. Other samplers go there too (a later
# flag overrides the preset's): --sampler dpm --ddim_steps 30, --sampler unipc
# --solver_order 2 --ddim_steps 20, --deepcache 5.
set -e
RES=${1:-512}
CKPT=${2:-checkpoints/dynamicrafter_${RES}_v1/model.ckpt}
PROMPTS=${3:-prompts/${RES}}
case $RES in
  256)  H=256; W=256;  FS=3;  EXTRA="--timestep_spacing uniform";;
  512)  H=320; W=512;  FS=24; EXTRA="--timestep_spacing uniform_trailing --guidance_rescale 0.7 --perframe_ae";;
  1024) H=576; W=1024; FS=10; EXTRA="--timestep_spacing uniform_trailing --guidance_rescale 0.7 --perframe_ae";;
  *) echo "unknown resolution $RES"; exit 1;;
esac
python -m dynamicrafter_tpu_torch.inference \
  --config configs/inference_${RES}_v1.0.yaml \
  --ckpt_path "$CKPT" --prompt_dir "$PROMPTS" \
  --savedir results/dynamicrafter_${RES} \
  --height $H --width $W --frame_stride $FS \
  --ddim_steps 50 --ddim_eta 1.0 --bs 1 \
  --unconditional_guidance_scale 7.5 --text_input --video_length 16 \
  --seed 123 --bf16 $EXTRA "${@:4}"
