"""Box geometry, losses, NMS and the stem: a frozen copy of the port's plain
PyTorch versions, with no kernel and no torch.library op behind them."""
