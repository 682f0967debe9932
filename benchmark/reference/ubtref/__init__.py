"""A frozen copy of the port's plain PyTorch modules (config, structures,
ops, modeling, the loaders' host arithmetic, the steps and the solver), with
every hand-written kernel replaced by its plain version. It imports nothing
of the port, so a change to the port leaves the yardstick where it was."""
