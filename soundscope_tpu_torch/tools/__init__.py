"""Command-line tools of the port: the float64 reference chain
(reference64.py), the conformance sweep (conformance.py), the library-scan
bench (library_scan_bench.py) and the end-to-end scan bench
(e2e_scan_bench.py)."""
