"""The benchmark's own machinery: the manifest, traffic, weights, the train
cell, the trace reduction, FLOP tables and the correctness comparison.
Nothing here imports the JAX package; the port is imported only by the
train cell, inside the functions that run a cell."""
