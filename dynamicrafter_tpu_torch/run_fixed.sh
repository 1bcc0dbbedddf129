#!/bin/bash
# Fixed-scheduler preset launcher of the PyTorch port (the JAX package's
# scripts/run_fixed.sh with the same flags): the run.sh presets plus the
# accepted --use_fixed_scheduler (the schedule tables are always fp64 with a
# guarded rescale) and the fixed-run output directory.
# usage: bash dynamicrafter_tpu_torch/run_fixed.sh <256|512|1024> [ckpt_path] [prompt_dir] [extra flags]
# A smoke run without weights passes --random_init among the extra flags.
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
  --savedir results/dynamicrafter_${RES}_fixed_seed123 \
  --height $H --width $W --frame_stride $FS \
  --ddim_steps 50 --ddim_eta 1.0 --bs 1 \
  --unconditional_guidance_scale 7.5 --text_input --video_length 16 \
  --seed 123 --bf16 --use_fixed_scheduler $EXTRA "${@:4}"
