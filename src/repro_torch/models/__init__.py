"""Model substrate in PyTorch: layers, attention (kernel K2 on the card)
with MLA, the MoE layer, the ssm layers (kernel K3), the transformer of the
dense, vlm, audio, ssm and moe families, and the converter from the
reference's parameters."""
