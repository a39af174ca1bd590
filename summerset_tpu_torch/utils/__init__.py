"""Leaf helpers (packed replica bitmaps on device)."""
