"""Training: the train step, EMA, checkpoints and metric logging."""
