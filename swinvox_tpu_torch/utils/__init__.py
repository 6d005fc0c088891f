"""Host utilities: the flax-msgpack codec of checkpoints, cuDNN settings,
meters, metrics log."""
