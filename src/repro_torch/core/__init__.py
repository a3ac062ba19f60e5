"""Numpy-only table primitives (twins of ``repro.core``)."""
