"""Synthetic scenes."""
