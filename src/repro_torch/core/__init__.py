"""Plain-PyTorch yCHG reference (``core.ychg``)."""
