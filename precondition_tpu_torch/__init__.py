"""precondition_tpu_torch: the PyTorch and CUDA port of precondition_tpu.

Runs the Shampoo optimizer's main path (the default, single-device mode
with stacked statistics) on an NVIDIA Hopper GPU, with the coupled-Newton
inverse-root solve as a hand-written CUDA kernel built from
``csrc/newton_root.cu`` at first use.  On the CPU every kernel's plain
PyTorch twin runs instead.  SM3 (`optim/sm3.py`) and the tearfree stack
(`tearfree/`, whose Newton and filtered roots take the same kernel) are
here too, and so is distribution over `torch.distributed` (`parallel/`,
`optim/sharded_shampoo.py`), and so are the JAX package's LM
(`models/transformer.py`), its train loop (`train/loop.py`), examples
and entry point (`entry.py`).  This package imports torch and never JAX;
the JAX package beside it is the reference its tests compare against.
"""

__version__ = "0.1.0"

from precondition_tpu_torch.optim.shampoo import (
    DistributedShampoo,
    GraftingType,
    PreconditionerType,
    distributed_shampoo,
)
from precondition_tpu_torch.optim.sm3 import sm3
from precondition_tpu_torch.tearfree import TearfreeOptions, tearfree
