"""Primitive ops and the hand-written kernels."""
