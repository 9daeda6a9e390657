"""The backward of the kernels' autograd Functions (counterpart of the JAX
package's custom_vjp rules, which differentiate the plain XLA forms): the
plain version re-run on the saved inputs under autograd."""

from __future__ import annotations

import torch


def plain_grads(fn, inputs, needs, grad_out):
    """The gradients of the plain version `fn` at `inputs` (tensors, None or
    static arguments) for those flagged in `needs` (None elsewhere),
    recomputed under autograd."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(n) if isinstance(t, torch.Tensor) else t
                  for t, n in zip(inputs, needs)]
        out = fn(*leaves)
        wanted = [t for t, n in zip(leaves, needs) if isinstance(t, torch.Tensor) and n]
        grads = iter(torch.autograd.grad(out, wanted, grad_out) if wanted else ())
    return tuple(next(grads) if isinstance(t, torch.Tensor) and n else None
                 for t, n in zip(leaves, needs))
