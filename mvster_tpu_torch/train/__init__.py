"""Training: schedules, metrics, checkpoints, logging and the epoch loop."""
