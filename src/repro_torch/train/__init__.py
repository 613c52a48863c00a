"""Training: optimizers, the fault-tolerant loop and checkpoints."""
