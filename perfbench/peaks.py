"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit).

f32 products count at TF32's peak: the port computes its f32 convolutions
on tensor cores by split products (K5, K10), so no f32 share may be taken
against the FMA pipe's 67 TFLOP/s, which one implementation (K2) alone is
bound by.
"""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {"f32": 495e12, "tf32": 495e12, "bf16": 989e12, "fp16": 989e12,
         "fp8": 1979e12, "int8": 1979e12}


def bound_s(bytes_moved: float, flops: float, precision: str) -> float:
    """The least time the card could take: the larger of the bytes (each
    input read once, each output written once) over the memory rate and
    the operations over the peak of the precision."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / FLOPS[precision])
