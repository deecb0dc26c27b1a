"""Host-side data: synthetic MODIS-like masks (NumPy only)."""
