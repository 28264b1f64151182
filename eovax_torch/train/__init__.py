"""Training: the stage-2 generator step and its schedule. Port of ``eovax/train``."""
