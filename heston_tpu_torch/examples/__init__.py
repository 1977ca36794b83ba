"""Worked examples of the port, run with `python -m` (see each module)."""
