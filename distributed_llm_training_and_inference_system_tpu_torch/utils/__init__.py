"""Small helpers shared by the training path."""
