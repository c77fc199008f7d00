"""Plain PyTorch float32 reference of the TBN, frozen inside the benchmark.

It imports torch alone: nothing of the measured program, nothing of the
JAX package. The benchmark hands it the same seeded parameters and inputs
it hands the program, and it works out again everything the program
derives from them (folded BatchNorm, rounded casts, kernel operands).
"""
