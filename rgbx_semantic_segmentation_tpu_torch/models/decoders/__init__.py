"""Decode heads."""
