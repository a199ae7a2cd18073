"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit).

The int32 rate: the data sheet's 67 TFLOP/s float32 counts an FMA as two
operations on 128 float32 lanes per SM; Hopper's SM has 64 int32 lanes
(NVIDIA H100 architecture whitepaper), so int32 issues at 67e12 / 4.
"""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
