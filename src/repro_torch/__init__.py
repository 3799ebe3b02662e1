"""PyTorch/CUDA port of the matrix-free HOSFEM solver (`repro` is the JAX
reference it is tested against).

The port imports torch and numpy only — never jax and never `repro`.  Its
entry points run on the CUDA device unless the caller passes
``device="cpu"``; the axhelm element kernels are hand-written CUDA for
Hopper (``kernels/axhelm/csrc/axhelm.cu``), built with ``nvcc`` at first use.

float32 matrix products stay in full float32 on the card: TF32 keeps about
three decimal digits, which would eat the 1e-4 operator budget of the plain
versions the kernels are held against.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
