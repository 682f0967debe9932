"""ResNet + FPN + FCOS head, target assignment, losses and decoding."""
