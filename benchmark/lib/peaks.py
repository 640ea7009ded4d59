"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, no sparsity,
at the 700 W power limit). A card set to a lower limit reaches less; the
result line names the card and its limit."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
