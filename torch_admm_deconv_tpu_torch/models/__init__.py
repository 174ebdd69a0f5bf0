"""Restoration models: layers, attention, blocks, ADMMDeconv, DivergentRestorer."""
