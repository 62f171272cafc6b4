"""The benchmark of soundscope_tpu_torch on the card: `python3 benchmark/run.py`.

It imports neither JAX nor the JAX package; it drives the port through
`systems.Program` and judges it against `reference/`.
"""
