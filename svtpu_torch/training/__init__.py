"""Training: the trainer, its objectives, schedule, checkpoints and
metrics logging (the port of ``svtpu/training``)."""
