"""Model substrate in PyTorch: layers, attention (kernel K2 on the card),
the dense-family transformer, and the converter from the reference's
parameters."""
