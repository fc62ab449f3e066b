"""Host utilities: masks and WAV I/O."""
