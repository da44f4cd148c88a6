"""The training examples' token pipeline."""
