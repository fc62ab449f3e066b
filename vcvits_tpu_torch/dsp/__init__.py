"""Host-side signal processing: resampling, pYIN pitch, pitch shifting."""
