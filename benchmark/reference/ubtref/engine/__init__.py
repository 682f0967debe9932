"""The train steps: a frozen copy of the port's."""
