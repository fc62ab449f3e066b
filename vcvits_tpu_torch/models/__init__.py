"""PyTorch modules of the 48 kHz conversion path, [B, T, C] layout."""
