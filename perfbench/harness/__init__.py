"""The benchmark of the PyTorch port (``repro_torch``): one training step
of a CNN in a closed loop, timed on the card and checked against a plain
reference.  See ``perfbench/run.py``."""
