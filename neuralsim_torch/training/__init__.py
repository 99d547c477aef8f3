"""Training: schedules, per-model optimizers and the trainer."""
