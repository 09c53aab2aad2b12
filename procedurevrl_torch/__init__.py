"""ProcedureVRL in PyTorch for NVIDIA Hopper (H100).

A port of ``procedurevrl_tpu`` (JAX on a TPU), which stays the numerical
reference.  The port imports neither JAX nor anything of that package.
Slice 1 covers zero-shot step classification on TimeSformer-B: the
multi-view test path (``procedurevrl_torch.tools.test_net``) with
hand-written CUDA kernels for the spatial and temporal attention forwards
(``procedurevrl_torch/csrc``).

Float32 products run in full float32 on the card: TF32 is switched off for
matrix products and cuDNN when the package is imported.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
