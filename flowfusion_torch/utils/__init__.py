"""Checkpoints (read and written), trees of tensors, weight conversion, toy
data and two-sample statistics."""
