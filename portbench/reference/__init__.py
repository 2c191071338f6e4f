"""The plain reference: frozen copies of the matrix generators and IC(0),
and a level-by-level triangular solve, SpMV and PCG in plain PyTorch.

It imports nothing of the program (``repro_torch``) and nothing of the JAX
package: it works out levels, the factor and the solves on its own, from the
same inputs the benchmark hands the program.
"""
