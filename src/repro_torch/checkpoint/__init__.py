"""Atomic keep-k checkpoints of nested dicts of tensors."""
