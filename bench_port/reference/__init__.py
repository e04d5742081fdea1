"""The plain reference: a per-level, per-frame detector in plain
PyTorch and NumPy, written from the algorithm's definition.  It imports
neither JAX, nor the JAX package, nor anything of the port, and takes
nothing the port has made: it rebuilds the pyramid plan, the filter
bank, the DP and the depth masks from the inputs the benchmark hands
it."""
