"""The plain reference that decides ``correct``: the AP-VAST hop worked out
again in float64 from the RIRs and the programs that the benchmark made,
with PyTorch and NumPy only. It imports nothing of the program under test
(``apvast_torch``), of the JAX package or of JAX; ``benchmark/tests``
checks that by its syntax tree.
"""
