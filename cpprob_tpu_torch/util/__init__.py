"""Utilities (this slice: profiling)."""
