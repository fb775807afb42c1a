"""The NVIDIA H100's published peaks (SXM part, dense, at the 700 W limit),
which every `mfu` and roofline share of the benchmark divides by.

The configurations compute in float32 with TF32 off; the fastest way the
card multiplies float32 inputs to float32 accuracy goes through the TF32
tensor cores (a split into three TF32 products), so the dense TF32 rate is
the ceiling no float32-accurate implementation can pass.
"""
PEAK_FLOPS = 495e12  # dense TF32, FLOP/s
PEAK_BYTES_PER_S = 3.35e12  # HBM3
