"""The benchmark's plain reference: BS.1770-4 loudness, EBU Tech 3342 LRA,
the 4x true peak and the pooled mid/side spectrogram, in float64 (and, as the control, in bfloat16).

It imports PyTorch and NumPy and nothing of the program under test; its
constants and design math are frozen copies (design.py).
"""
