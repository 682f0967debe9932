"""The plain PyTorch version of each of the port's hand-written kernels,
under the module names the port's callers import them by. Every function
runs the same arithmetic on any device; nothing is compiled or launched."""
