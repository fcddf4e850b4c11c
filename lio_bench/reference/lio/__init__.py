"""A frozen copy of limovelo_tpu_torch's single-device plain path."""

import torch as _torch

# true float32 products, as the program computes them (the control of the
# comparison switches TF32 on around one replay: see ../replay.py)
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
