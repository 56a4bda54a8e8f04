"""SAM2 fine-tuning: the loss and train step, step checkpoints, and the training loop."""
