"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the 700 W power limit)."""

# float32 matrix products on the TF32 tensor cores: the peak of the
# precision the configurations state (float32), whatever implements it
PEAK_FLOPS = {'float32': 494.7e12, 'bfloat16': 989.4e12}
PEAK_BYTES_PER_S = 3.35e12   # HBM3
