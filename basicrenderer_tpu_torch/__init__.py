"""basicrenderer_tpu_torch: the PyTorch + CUDA port of basicrenderer_tpu.

The port mirrors the JAX package's module paths and names. Plain tensor
code is PyTorch; every Pallas kernel of the JAX package becomes a kernel
written by hand for NVIDIA Hopper (sources under `csrc/`, built at first
use). The JAX package stays the reference: the tests feed both packages
the same inputs.

Numerics note: the JAX package forces "highest" f32 matmul precision
because TPU matmuls default to bf16 passes. The CUDA counterpart is TF32,
which PyTorch may use for f32 matmuls and cuDNN convolutions; both are
switched off here so that every f32 product in the port is a true f32
product on the card as on the CPU.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
