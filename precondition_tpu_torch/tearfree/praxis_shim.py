"""The tearfree stack's chain of gradient transformations.

PyTorch counterpart of `precondition_tpu/tearfree/praxis_shim.py`, its
init/update chain only: praxis partition specs (`init_partition_spec`,
`WeightHParams`) describe the sharding of JAX arrays and have no meaning
for torch tensors.  A stage with no state holds None where JAX holds an
`optax.MaskedNode`.
"""

from __future__ import annotations

from precondition_tpu_torch.optim.shampoo import GradientTransformation


def sharded_chain(*transforms: GradientTransformation
                  ) -> GradientTransformation:
  """``transforms`` applied in order; the state is the tuple of theirs."""

  def init_fn(params):
    return tuple(tx.init(params) for tx in transforms)

  def update_fn(updates, state, params=None):
    if len(transforms) != len(state):
      raise ValueError(
          f"sharded_chain: {len(transforms)} transforms but "
          f"{len(state)} states")
    new_states = []
    for s, tx in zip(state, transforms):
      updates, s = tx.update(updates, s, params)
      new_states.append(s)
    return updates, tuple(new_states)

  return GradientTransformation(init_fn, update_fn)
