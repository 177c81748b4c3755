"""Training: train state, checkpoints, metrics, infeed and the trainer."""
