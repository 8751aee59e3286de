"""Checkpoints (read and written), trees of tensors, weight conversion, toy
data, two-sample statistics and the serving artifacts."""
