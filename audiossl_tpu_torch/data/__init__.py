"""Host-side data handling (WAV decode)."""
