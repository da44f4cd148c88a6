"""Training: AdamW, checkpoints, gradient compression, fault tolerance."""
