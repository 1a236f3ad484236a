"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each public wrapper runs the plain version for a CPU tensor and launches its
CUDA kernel for a CUDA tensor (or raises); it counts its launches in a plain
integer attribute, `<wrapper>.launches`.
"""
