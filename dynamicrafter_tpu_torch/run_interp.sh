#!/bin/bash
# Interpolation / looping fine-tune launcher of the PyTorch port (the JAX
# package's scripts/run_interp.sh with the same flags): the 512 recipe with
# interp_mode on, rand_cond_frame off and the interp pretrained weights
# (configs/training_512_interp.yaml; without them the weights are random).
# usage: bash dynamicrafter_tpu_torch/run_interp.sh [save_root] [extra flags]
# e.g. extra flags --synthetic_data --bf16 --max_steps 4 for a smoke run.
set -e
SAVE_ROOT=${1:-runs}
NAME=training_512_interp

mkdir -p "$SAVE_ROOT/$NAME"

python -m dynamicrafter_tpu_torch.train \
  --base configs/training_512_interp.yaml \
  --train \
  --name "$NAME" \
  --logdir "$SAVE_ROOT" \
  "${@:2}"
