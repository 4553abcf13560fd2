"""Tensor operations of the protocol tick."""
