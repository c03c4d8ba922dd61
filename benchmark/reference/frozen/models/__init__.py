"""Part of the frozen copy (see the package docstring)."""
