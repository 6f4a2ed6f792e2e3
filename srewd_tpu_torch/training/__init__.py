"""Training: optimizers, checkpoints, metrics and the DiffusionTrainer loops."""
