"""Host-side data helpers."""
