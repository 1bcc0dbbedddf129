"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): the yardstick of every roofline and mfu."""
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
