"""Multi-device rendering: the frame split into screen row bands (tiles.py)."""
