"""Checkpoint reading, weight conversion, toy data and two-sample statistics."""
