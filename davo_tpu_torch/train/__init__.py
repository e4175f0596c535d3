"""Training: losses, the train step, the fit loop and checkpoints."""
