"""Grasp label geometry."""
