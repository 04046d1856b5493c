"""Serving runtime: the hybrid batch tier."""
