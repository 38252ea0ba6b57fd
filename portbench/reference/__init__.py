"""The plain reference: NumPy and the standard library only."""
