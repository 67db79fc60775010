"""Roofline bridge of the port (the design-space half only)."""
