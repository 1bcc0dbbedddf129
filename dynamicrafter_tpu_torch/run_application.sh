#!/bin/bash
# Interpolation / looping launcher of the PyTorch port (the JAX package's
# scripts/run_application.sh with the same flags): the 512 model, frame
# stride 5, the 512-interp checkpoint by default.
# usage: bash dynamicrafter_tpu_torch/run_application.sh <interp|loop> [ckpt_path] [prompt_dir] [extra flags]
# --interp wants two images per prompt line. A smoke run without weights
# passes --random_init among the extra flags.
set -e
MODE=${1:-interp}
CKPT=${2:-checkpoints/dynamicrafter_512_interp_v1/model.ckpt}
PROMPTS=${3:-prompts/512_${MODE}}
python -m dynamicrafter_tpu_torch.inference \
  --config configs/inference_512_v1.0.yaml \
  --ckpt_path "$CKPT" --prompt_dir "$PROMPTS" \
  --savedir results/dynamicrafter_512_${MODE} \
  --height 320 --width 512 --frame_stride 5 \
  --ddim_steps 50 --ddim_eta 1.0 --bs 1 \
  --unconditional_guidance_scale 7.5 --text_input --video_length 16 \
  --timestep_spacing uniform_trailing --guidance_rescale 0.7 --perframe_ae \
  --seed 123 --bf16 --${MODE} "${@:4}"
