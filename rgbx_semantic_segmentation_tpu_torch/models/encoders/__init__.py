"""Dual-branch encoders."""
