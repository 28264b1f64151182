"""Training: the stage-2 generator step, its schedule and the trainer. Port of ``eovax/train``."""
