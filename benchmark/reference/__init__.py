"""The plain reference of the benchmark: HoloDiffusion's training step,
chunked render and DDPM step, written out in float32 PyTorch.

It is a frozen copy of the plain paths the release configurations take
(ResNet34 extractor, the MLPMean and AngleWeighted aggregators, the 3D UNet,
ray sampling, a trilinear decode written out in full, the emission-absorption
raymarcher, the DDPM step and Adam). It imports nothing of the program under
test and reads its sizes from the configuration dict the benchmark holds.
Precision is float32 with TF32 off, unless a caller asks for the control's
lower precision (`precision(tf32=True)`).
"""
