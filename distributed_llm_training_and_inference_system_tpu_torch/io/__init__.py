"""Data streaming and checkpoints for the training path."""
