"""Solver operators: shrinkage, finite differences, transforms, ADMM."""
