"""Kernel routing defaults."""
