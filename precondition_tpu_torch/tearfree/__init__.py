"""Tearfree: the modular second-order optimizer stack, in PyTorch.

``tearfree()`` chains grafting of (merge -> blocked Shampoo | Sketchy ->
unmerge), momentum and the learning rate, with one shared momentum buffer.
Counterpart of `precondition_tpu/tearfree/` (all but its `reallocation`).
"""

from precondition_tpu_torch.tearfree.optimizer import TearfreeOptions, tearfree
