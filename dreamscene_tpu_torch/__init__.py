"""dreamscene_tpu_torch: the PyTorch / CUDA port of dreamscene_tpu.

Generates objects (Formation Pattern Sampling, densify/prune, importance
filtering, the refine phase, PLY output; `python -m dreamscene_tpu_torch
--object`) on one NVIDIA H100. The JAX package beside it is the reference
each module is held against; this package imports nothing of it, nor of
JAX.

Precision: float32 matrix products and convolutions run in full float32
(TF32 off for both cuBLAS and cuDNN), as the JAX package runs its
projection/SH/covariance products at Precision.HIGHEST. bf16 comes only
from a guidance config's compute dtype.

Hand-written CUDA kernels (csrc/*.cu, built by kernels.py at first use)
replace the JAX package's Pallas kernels: the rasterizer's three (K1-K3)
and the flash attention's forward and two backward kernels (K4); each
wrapper launches its kernel for CUDA tensors and runs its plain PyTorch
version for CPU tensors only.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
