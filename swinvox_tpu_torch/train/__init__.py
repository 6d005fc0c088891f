"""Training: per-module optimizers, the train state and the train step."""
