"""Trust-region machinery (port of ``fsrl_tpu/ops/cg.py``): flat-parameter
utilities, Fisher-vector products, conjugate gradient and backtracking line
search, as tensor code without a host sync.

The JAX package takes the Hessian-vector product forward-over-reverse
(``jax.jvp(jax.grad(kl))``). Here it is double backward: the gradient of the
KL is built once with its graph, and each product is one backward pass
through that graph, ``grad(grad_kl . v)``. Both are the same matrix.
"""

from __future__ import annotations

from typing import Callable

import torch

Tensor = torch.Tensor


def flatten(tensors: dict[str, Tensor]
            ) -> tuple[Tensor, Callable[[Tensor], dict[str, Tensor]]]:
    """Named tensors -> (flat vector, unravel). ``unravel(flat)`` returns
    views of ``flat`` under the same names and shapes, in the dict's
    order."""
    names = list(tensors)
    shapes = [tensors[k].shape for k in names]
    flat = torch.cat([tensors[k].reshape(-1) for k in names])

    def unravel(vec: Tensor) -> dict[str, Tensor]:
        out, off = {}, 0
        for k, shape in zip(names, shapes):
            n = shape.numel()
            out[k] = vec[off: off + n].view(shape)
            off += n
        return out

    return flat, unravel


def make_fvp(kl_fn: Callable[[Tensor], Tensor], flat0: Tensor,
             damping: float = 0.1) -> Callable[[Tensor], Tensor]:
    """``fvp(v) = (H_kl + damping * I) v`` at ``flat0``, where
    ``kl_fn(flat) -> scalar`` is the mean KL(old || new) at the flat
    parameters ``flat``. Works under ``torch.no_grad()``: the graph is built
    here with grad enabled and kept for the products."""
    with torch.enable_grad():
        f = flat0.detach().clone().requires_grad_(True)
        (grad_kl,) = torch.autograd.grad(kl_fn(f), f, create_graph=True)

    def fvp(v: Tensor) -> Tensor:
        (hv,) = torch.autograd.grad(grad_kl, f, v, retain_graph=True)
        return hv + damping * v

    return fvp


@torch.no_grad()
def conjugate_gradient(mvp: Callable[[Tensor], Tensor], b: Tensor,
                       n_iters: int = 10,
                       residual_tol: float = 1e-8) -> Tensor:
    """Solve ``A x = b`` with ``n_iters`` CG iterations. Iterations after
    the squared residual has fallen to ``residual_tol`` are masked no-ops,
    so the loop never reads a value back to the host."""
    x, r, p = torch.zeros_like(b), b, b
    rdotr = torch.dot(b, b)
    for _ in range(n_iters):
        z = mvp(p)
        alpha = rdotr / (torch.dot(p, z) + 1e-12)
        x_new = x + alpha * p
        r_new = r - alpha * z
        new_rdotr = torch.dot(r_new, r_new)
        beta = new_rdotr / (rdotr + 1e-12)
        p_new = r_new + beta * p
        live = rdotr > residual_tol
        x, r, p = (torch.where(live, a, o)
                   for a, o in ((x_new, x), (r_new, r), (p_new, p)))
        rdotr = torch.where(live, new_rdotr, rdotr)
    return x


def backtrack_fractions(coeff: float, max_backtracks: int,
                        like: Tensor) -> Tensor:
    """``coeff ** arange(max_backtracks)`` in ``like``'s dtype and device."""
    return torch.pow(
        torch.as_tensor(coeff, dtype=like.dtype, device=like.device),
        torch.arange(max_backtracks, dtype=like.dtype, device=like.device))


@torch.no_grad()
def backtracking_line_search(eval_fn: Callable[[Tensor], object],
                             accept_fn: Callable[[object, Tensor], Tensor],
                             flat_params: Tensor, full_step: Tensor,
                             max_backtracks: int = 10,
                             backtrack_coeff: float = 0.8):
    """Evaluate ``accept_fn(eval_fn(flat_params + frac * full_step), frac)``
    (a 0-d bool tensor) for every ``frac = backtrack_coeff ** i`` and take
    the first accepted step, or no step if none is accepted: the
    early-breaking host loop without a host sync.

    Returns ``(new_flat_params, accepted, frac_used)``."""
    fracs = backtrack_fractions(backtrack_coeff, max_backtracks, flat_params)
    oks = torch.stack([accept_fn(eval_fn(flat_params + frac * full_step),
                                 frac) for frac in fracs])
    any_ok = oks.any()
    first = torch.argmax(oks.to(torch.int32))      # the first maximum
    frac = torch.where(any_ok, fracs[first], torch.zeros_like(fracs[0]))
    return flat_params + frac * full_step, any_ok, frac
