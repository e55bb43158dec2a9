"""Serving: waveform -> embedding (serve/export.py)."""
