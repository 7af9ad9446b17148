"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): the table every roofline share of
the benchmark is taken against.  A card set below 700 W reaches less;
the result line carries the card's power limit beside the shares."""

# FLOP/s by dtype: f64 on the tensor cores, f32 outside them
FLOPS = {"float64": 67e12, "float32": 67e12}
# HBM3 bandwidth, bytes/s
BYTES_PER_S = 3.35e12
