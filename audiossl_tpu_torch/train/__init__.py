"""Pretraining: optimizers, the train step, checkpoints and the loop."""
