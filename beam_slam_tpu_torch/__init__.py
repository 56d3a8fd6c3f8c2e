"""beam_slam_tpu_torch — the PyTorch/CUDA port of ``beam_slam_tpu``.

The JAX package beside it is the reference; every module here mirrors the
module of the same path there and is held against it by the parity tests
(``tests/test_torch_*.py``).

Numerical policy: everything is float32, and float32 products stay full
float32. The reference raised JAX's matmul precision because reduced-
precision products moved a flagship LM solve by about 1 cm
(``beam_slam_tpu/__init__.py``); TF32 truncates the mantissa the same way,
so it is switched off for matmuls and convolutions alike.
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
