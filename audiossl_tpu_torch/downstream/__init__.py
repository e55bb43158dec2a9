"""Downstream encoder + head."""
