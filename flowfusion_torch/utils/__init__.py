"""Checkpoint reading, weight conversion and toy data."""
