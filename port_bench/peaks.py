"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the card's 700 W limit). A share of a peak or of a roofline is
taken against these, whatever the power limit of the card that ran."""

PEAK_TF32_FLOPS = 495e12     # tensor cores, TF32 (an fp32 step's product format)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12   # HBM3
