"""Data pipeline (``repro/data``), pure NumPy."""
