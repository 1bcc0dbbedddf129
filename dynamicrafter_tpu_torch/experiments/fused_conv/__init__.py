"""Fused GroupNorm -> SiLU -> 3x3 conv: statistics in the kernel (K7) and
row-tiled from a statistics pre-pass (K8)."""
