"""Command-line tools of the port: the float64 reference chain
(reference64.py) and the conformance sweep (conformance.py)."""
