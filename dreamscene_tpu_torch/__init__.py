"""dreamscene_tpu_torch: the PyTorch / CUDA port of dreamscene_tpu.

Runs the object Formation-Pattern-Sampling training step on one NVIDIA
H100. The JAX package beside it is the reference each module is held
against; this package imports nothing of it, nor of JAX.

Precision: float32 matrix products and convolutions run in full float32
(TF32 off for both cuBLAS and cuDNN), as the JAX package runs its
projection/SH/covariance products at Precision.HIGHEST. bf16 comes only
from a guidance config's compute dtype.

Hand-written CUDA kernels (csrc/*.cu, built by kernels.py at first use)
replace the JAX package's three Pallas kernels; each wrapper launches its
kernel for CUDA tensors and runs its plain PyTorch version for CPU
tensors only.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
