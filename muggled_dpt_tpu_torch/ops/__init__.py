"""Functional ops on torch tensors, and the hand-written kernels."""
