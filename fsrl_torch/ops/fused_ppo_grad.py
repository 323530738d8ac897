"""Kernel K2: the whole PPO-Lagrangian minibatch loss and its hand-derived
gradient, in one of three CUDA forms that the layout's shape alone picks
(:func:`kernel_form`). At hidden (128, 128) and up to 32 actions, the tuned
forms, one fused launch plus a fixed-order reduce launch: with
``bf16=True`` ``csrc/fused_ppo_grad.cu``, every product of a 128-row chunk on
Hopper's tensor cores (``wgmma``) from bf16 tiles that the kernel writes into
shared memory itself (:func:`tile_offset` mirrors their layout); with
``bf16=False`` ``csrc/fused_ppo_grad_f32.cu``, the same products with
``mma.sync``, each float32 product taken as three TF32 products of the
operands' high and low parts (:func:`tf32_split` mirrors the split), which
keeps the gradient within a few 1e-6 of each tensor's largest entry of the
plain float32 version. At every other shape of the gate, hidden widths
(H1, H2) and any number of actions, the generic form
``csrc/fused_ppo_grad_any.cu``: three launches (a row kernel that runs
both layers, the heads, the row loss and the backward pass to g_h1 for a
block of 64 rows, a kernel of the weight-gradient products over slices of
the rows, and the fixed-order reduce), its products on ``wgmma`` (bf16) or
as three TF32 ``mma.sync`` products (f32), counted apart
(``fused_ppo_grad_any``, ``fused_ppo_grad_any_f32``); how its row kernel
stages the slices of its trunk products follows from the shape
(:func:`any_staging`, counted in :data:`STAGINGS`).

Replaces ``fsrl_tpu/ops/fused_ppo_grad.py::ppo_grad_minibatch``. The math is
the Pallas kernel's (``fused_ppo_grad.py:68-165``):

* actor: two ReLU layers (widths H1, H2), ``tanh`` mean, free log-sigma,
  Gaussian log-prob, ratio, clipped surrogate plus
  ``sum_m lam_m * mean(ratio * advC_m)``,
  all scaled by ``resc`` (the ``1 / (sum lam + 1)`` rescale);
* K critic towers with ``vf_coef * mean((v - ret)^2)`` each;
* JAX's tie conventions: d min(s1, s2) splits 0.5/0.5 at s1 == s2, and the
  clip passes 0.5 at ``ratio == 1 +- eps`` (material: every epoch's first
  grad step has ratio == 1 on almost every row);
* with ``bf16=True`` every matmul operand that the Pallas kernel casts to
  bf16 is rounded to bf16, products accumulate in float32, activations,
  biases and the actor's mean head stay float32.

Parameters and gradients are the flat vector of
:class:`fsrl_torch.nets.mlp.ActorCritic` (see :class:`GradLayout`). On a CUDA
tensor the wrapper launches the kernel or raises; on a CPU tensor it runs
:func:`ppo_grad_plain`, which computes the same hand-derived gradient with
PyTorch operations (not autograd: autograd's ``clamp`` passes the full
gradient at the clip bounds).
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass

import torch

from fsrl_torch.ops import kernels

LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
AUX_WIDTH = 8
KERNEL_H = 128       # the tuned forms' tiling is written for width 128
KERNEL_A_MAX = 32    # the tuned f32 kernel's shared memory: 200 KB of
                     # float32 tiles, and 580 bytes an action of head weights
                     # and sums, fill a block's 232,448 bytes at A 32, K 6
KERNEL_M_MAX = 5     # the aux row holds 3 + M sums in 8 slots
ANY_OSMALL = 8       # the generic form's row kernel has an instance of its
                     # own above 8 actions (OSMALL in fused_ppo_grad_any.cu)


@dataclass(frozen=True)
class GradLayout:
    """Shapes of the flat parameter vector for a two-hidden-layer
    ActorCritic of widths (H, H2) (``H2`` defaults to ``H``): observation
    D, action A, K critics. The order is ``ActorCritic.flat_names()``."""

    D: int
    H: int
    A: int
    K: int
    H2: int | None = None

    def __post_init__(self):
        if self.H2 is None:
            object.__setattr__(self, "H2", self.H)

    def shapes(self) -> list[tuple[str, tuple[int, ...]]]:
        D, H1, H2, A, K = self.D, self.H, self.H2, self.A, self.K
        return [
            ("actor.trunk.layers.0.weight", (H1, D)),
            ("actor.trunk.layers.0.bias", (H1,)),
            ("actor.trunk.layers.1.weight", (H2, H1)),
            ("actor.trunk.layers.1.bias", (H2,)),
            ("actor.mu.weight", (A, H2)),
            ("actor.mu.bias", (A,)),
            ("actor.log_sigma", (A,)),
            ("critics.w.0", (K, H1, D)), ("critics.b.0", (K, H1)),
            ("critics.w.1", (K, H2, H1)), ("critics.b.1", (K, H2)),
            ("critics.w.2", (K, 1, H2)), ("critics.b.2", (K, 1)),
        ]

    @property
    def size(self) -> int:
        return sum(math.prod(s) for _, s in self.shapes())

    def views(self, flat: torch.Tensor) -> dict[str, torch.Tensor]:
        out, off = {}, 0
        for name, shape in self.shapes():
            n = math.prod(shape)
            out[name] = flat[off: off + n].view(shape)
            off += n
        return out

    def kernel_fits(self) -> bool:
        """Shapes K2 takes, the shape part of the Pallas kernel's gate (it
        reads the widths from the weights and holds each weight whole): any
        hidden widths, observation width and number of actions, and up to
        ``KERNEL_M_MAX`` constraints (the aux row's 8 slots hold 3 + M
        sums, in the Pallas kernel too)."""
        return (min(self.D, self.H, self.H2, self.A) >= 1
                and 1 <= self.K <= KERNEL_M_MAX + 1)


def kernel_form(layout: GradLayout) -> str:
    """The CUDA form of K2 that a layout inside the gate takes: "tuned"
    (``csrc/fused_ppo_grad.cu`` / ``fused_ppo_grad_f32.cu``) at hidden
    (128, 128) with up to ``KERNEL_A_MAX`` actions, at any D and K; "any"
    (``csrc/fused_ppo_grad_any.cu``) at every other shape."""
    return ("tuned" if layout.H == layout.H2 == KERNEL_H
            and layout.A <= KERNEL_A_MAX else "any")


def launch_name(layout: GradLayout, bf16: bool) -> str:
    """The ``kernels.LAUNCHES`` key of the form and dtype K2 launches at
    ``layout``: the tuned bf16 and f32 kernels and the generic form's two
    dtypes are counted apart."""
    name = "fused_ppo_grad" + ("" if kernel_form(layout) == "tuned"
                               else "_any")
    return name if bf16 else name + "_f32"


# Launches of the generic form's row kernel by how it stages the slices of
# its trunk products (:func:`any_staging`), counted where
# ``kernels.LAUNCHES`` is.
STAGINGS: collections.Counter = collections.Counter()


def any_staging(layout: GradLayout, bf16: bool) -> str:
    """How the generic form's row kernel stages the operand slices of its
    trunk products h1 W2^T and g_h2 W2 (stages B and D): "vector" in f32 at
    up to :data:`ANY_OSMALL` actions (the instance the main f32 paths
    launch: each thread loads its share of a slice 16 bytes at a time and
    stores it so, W2's split into its TF32 parts on the way), "scalar"
    elsewhere (bf16, and f32 above 8 actions: 4 bytes a load). Both give
    the same bits."""
    return ("vector" if not bf16 and layout.A <= ANY_OSMALL
            else "scalar")


def tile_offset(r: int, c: int, n_col_groups: int) -> int:
    """Byte offset of element (r, c) of a bf16 tile in the layout the bf16
    kernel's tensor-core products read (``wg::tile_off`` in
    ``csrc/wgmma.cuh``): 8x8 core matrices of 128 contiguous bytes, row-major
    inside (16 bytes a row), core matrix (r // 8, c // 8) at
    ``((r // 8) * n_col_groups + c // 8) * 128``."""
    return ((((r >> 3) * n_col_groups + (c >> 3)) << 7) + ((r & 7) << 4)
            + ((c & 7) << 1))


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The f32 kernel's split of a float32 operand into two TF32 values
    (``tf32::split`` in ``csrc/mma_tf32.cuh``): ``hi`` is ``x`` rounded to
    10 fraction bits, to nearest with ties away from zero (as
    ``cvt.rna.tf32.f32``; the kernel adds half an ulp to the bits), and
    ``lo`` is ``x - hi`` (exact in float32) rounded the same way, so
    ``x - hi - lo`` is at most ``2**-22 * |x|``. The
    kernel takes a product ``a b`` as ``hi_a hi_b + hi_a lo_b + lo_a hi_b``
    summed in float32. A mirror for the tests, used by nothing on the main
    path."""
    def rna(v):
        bits = v.float().contiguous().view(torch.int32)
        return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def _bf(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    return x.to(torch.bfloat16).float() if bf16 else x


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the f32 kernels take a product: three TF32 products of
    the operands' :func:`tf32_split` parts, ``hi_a hi_b + hi_a lo_b +
    lo_a hi_b``, each exact in float32 and summed in float32. A mirror for
    the tests, used by nothing on the main path."""
    ha, la = tf32_split(a)
    hb, lb = tf32_split(b)
    return ha @ lb + la @ hb + ha @ hb


def _actor_forward(p, x, act, A: int, bf16: bool, mm=None):
    """The kernel's actor forward: trunk matmuls on bf16-rounded operands
    (when ``bf16``; ``mm`` takes them instead where given), f32 mean head,
    ``tanh`` mean and the log-prob."""
    mm = mm or (lambda a, b: _bf(a, bf16) @ _bf(b, bf16))
    W1, b1 = p["actor.trunk.layers.0.weight"], p["actor.trunk.layers.0.bias"]
    W2, b2 = p["actor.trunk.layers.1.weight"], p["actor.trunk.layers.1.bias"]
    Wmu, bmu = p["actor.mu.weight"], p["actor.mu.bias"]
    lsig = p["actor.log_sigma"]
    h1 = torch.relu(mm(x, W1.T) + b1)
    h2 = torch.relu(mm(h1, W2.T) + b2)
    mu = torch.tanh(h2 @ Wmu.T + bmu)
    z = (act - mu) / torch.exp(lsig)
    logp = (-0.5 * z * z).sum(1) - lsig.sum() - A * LOG_SQRT_2PI
    return h1, h2, mu, z, logp


def policy_logp(flat, layout: GradLayout, obs, act, *, bf16: bool = False):
    """Log-prob of ``act`` as the plain version computes it (tests use it
    to make rows whose ratio is exactly 1)."""
    return _actor_forward(layout.views(flat), obs, act, layout.A, bf16)[-1]


# The card checks of the f32 kernel draw their rows at least this far from
# every ReLU kink (:func:`redraw_near_kinks`), in at most this many draws.
KINK_MARGIN = 2e-5
_KINK_DRAWS = 10


def relu_margin(flat, layout: GradLayout, obs) -> torch.Tensor:
    """Per row of ``obs``, the smallest ``|pre-activation|`` of any hidden
    unit of any tower (actor and K critics), in float64. Where it is within
    rounding of 0, two float32 computations of the gradient (the kernel and
    the plain version, or either and exact arithmetic) can take different
    sides of the ReLU, and the row's whole gradient through that unit
    differs: at 32,768 rows a random draw is likely to hold such a row. For
    the card checks (the tests and ``chip_smoke.py``), used by nothing on
    the main path."""
    p = layout.views(flat.double())
    x = obs.double()
    towers = [tuple(p[f"actor.trunk.layers.{i}.{n}"]
                    for i in (0, 1) for n in ("weight", "bias"))]
    towers += [(p["critics.w.0"][k], p["critics.b.0"][k], p["critics.w.1"][k],
                p["critics.b.1"][k]) for k in range(layout.K)]
    margin = torch.full((x.shape[0],), math.inf, dtype=torch.float64,
                        device=x.device)
    for W1, b1, W2, b2 in towers:
        z1 = x @ W1.T + b1
        z2 = torch.relu(z1) @ W2.T + b2
        margin = torch.minimum(margin, torch.minimum(z1.abs().amin(1),
                                                     z2.abs().amin(1)))
    return margin


def redraw_near_kinks(flat, layout: GradLayout, obs, draw):
    """``obs`` with each row whose :func:`relu_margin` is below
    :data:`KINK_MARGIN` replaced by a row of ``draw(n)`` (``n`` new rows),
    until none is left. The pre-activations spread about 0.2 at the port's
    init, so a few percent of rows are drawn again. For the card checks,
    used by nothing on the main path."""
    obs = obs.clone()
    for _ in range(_KINK_DRAWS):
        near = relu_margin(flat, layout, obs) < KINK_MARGIN
        if not near.any():
            return obs
        obs[near] = draw(int(near.sum())).to(obs)
    raise RuntimeError(f"rows still within {KINK_MARGIN} of a ReLU kink "
                       f"after {_KINK_DRAWS} draws")


def ppo_grad_plain(flat, layout: GradLayout, obs, act, logp_old, adv, ret,
                   lam, resc, *, eps_clip: float, vf_coef: float,
                   bf16: bool, mm=None):
    """Plain PyTorch version of the kernel: returns ``(grad, aux_row)`` with
    ``grad`` in the layout of ``flat`` and ``aux_row`` (8,) holding
    [sum(logp_old - logp), sum(min surrogate), sum_k sum(diff^2),
    sum(ratio * advC_m) for m < M, zeros]. ``mm``, where given, takes the
    trunk and weight-gradient products (z1, z2, g_h2 W2, g_h2^T h1,
    g_h1^T x) in place of the plain matmul (the tests pass
    :func:`tf32x3_matmul`)."""
    p = layout.views(flat)
    B = obs.shape[0]
    K = layout.K
    M = K - 1
    hm = lambda a, b: _bf(a, bf16) @ _bf(b, bf16)
    mm = mm or hm
    x = obs
    grads: dict[str, torch.Tensor] = {}

    # actor forward
    W2 = p["actor.trunk.layers.1.weight"]
    Wmu = p["actor.mu.weight"]
    sig = torch.exp(p["actor.log_sigma"])
    h1, h2, mu, z, logp = _actor_forward(p, x, act, layout.A, bf16, mm)
    ratio = torch.exp(logp - logp_old)
    lo_b, hi_b = 1.0 - eps_clip, 1.0 + eps_clip
    advr = adv[:, 0]
    rc = torch.clamp(ratio, lo_b, hi_b)
    s1, s2 = ratio * advr, rc * advr
    mins = torch.minimum(s1, s2)
    w1 = torch.where(s1 < s2, 1.0, torch.where(s1 == s2, 0.5, 0.0))
    w2 = 1.0 - w1
    inside = torch.where((ratio > lo_b) & (ratio < hi_b), 1.0,
                         torch.where((ratio == lo_b) | (ratio == hi_b),
                                     0.5, 0.0))
    dmin_dr = advr * (w1 + w2 * inside)
    cadv = adv[:, 1:]
    g_ratio = resc * (-dmin_dr + (cadv * lam).sum(1)) / B
    g_logp = g_ratio * ratio

    # actor backward
    g_mu_raw = g_logp[:, None] * (z / sig) * (1.0 - mu * mu)
    grads["actor.log_sigma"] = (g_logp[:, None] * (z * z - 1.0)).sum(0)
    grads["actor.mu.weight"] = g_mu_raw.T @ h2
    grads["actor.mu.bias"] = g_mu_raw.sum(0)
    g_h2 = (g_mu_raw @ Wmu) * (h2 > 0)
    grads["actor.trunk.layers.1.weight"] = mm(g_h2.T, h1)
    grads["actor.trunk.layers.1.bias"] = g_h2.sum(0)
    g_h1 = mm(g_h2, W2) * (h1 > 0)
    grads["actor.trunk.layers.0.weight"] = mm(g_h1.T, x)
    grads["actor.trunk.layers.0.bias"] = g_h1.sum(0)

    # critic towers
    cw1, cb1 = p["critics.w.0"], p["critics.b.0"]
    cw2, cb2 = p["critics.w.1"], p["critics.b.1"]
    cwv, cbv = p["critics.w.2"], p["critics.b.2"]
    gc = {n: [] for n in ("w.0", "b.0", "w.1", "b.1", "w.2", "b.2")}
    vf = torch.zeros((), device=x.device)
    for k in range(K):
        h1k = torch.relu(mm(x, cw1[k].T) + cb1[k])
        h2k = torch.relu(mm(h1k, cw2[k].T) + cb2[k])
        v = (hm(h2k, cwv[k].T) + cbv[k])[:, 0]
        diff = v - ret[:, k]
        vf = vf + (diff * diff).sum()
        g_v = (2.0 * vf_coef / B) * diff
        gc["w.2"].append(hm(g_v[None], h2k))
        gc["b.2"].append(g_v.sum(0, keepdim=True))
        g_h2k = hm(g_v[:, None], cwv[k]) * (h2k > 0)
        gc["w.1"].append(mm(g_h2k.T, h1k))
        gc["b.1"].append(g_h2k.sum(0))
        g_h1k = mm(g_h2k, cw2[k]) * (h1k > 0)
        gc["w.0"].append(mm(g_h1k.T, x))
        gc["b.0"].append(g_h1k.sum(0))
    for n, parts in gc.items():
        grads[f"critics.{n}"] = torch.stack(parts)

    grad = torch.cat([grads[n].reshape(-1) for n, _ in layout.shapes()])
    aux = torch.zeros(AUX_WIDTH, device=x.device)
    aux[0] = (logp_old - logp).sum()
    aux[1] = mins.sum()
    aux[2] = vf
    if M > 0:
        aux[3: 3 + M] = (ratio[:, None] * cadv).sum(0)
    return grad, aux


def _launch(flat, layout: GradLayout, obs, act, logp_old, adv, ret, lam,
            resc, *, eps_clip: float, vf_coef: float, bf16: bool):
    B, D = obs.shape
    K, A = layout.K, layout.A
    req = kernels.require
    req(layout.kernel_fits(),
        f"fused PPO grad kernel takes any widths and K-1<={KERNEL_M_MAX}; "
        f"got {layout}")
    expect = {"flat": (flat, (layout.size,)), "obs": (obs, (B, layout.D)),
              "act": (act, (B, A)), "logp_old": (logp_old, (B,)),
              "adv": (adv, (B, K)), "ret": (ret, (B, K)),
              "lam": (lam, (K - 1,)), "resc": (resc, ())}
    for name, (x, shape) in expect.items():
        req(x.is_cuda and x.device == flat.device
            and x.dtype == torch.float32 and x.is_contiguous()
            and tuple(x.shape) == shape,
            f"fused PPO grad kernel: {name} must be a contiguous float32 "
            f"tensor of shape {shape} on {flat.device}, got {x.dtype} "
            f"{tuple(x.shape)} on {x.device}")
    lib = kernels.library()
    grad = torch.empty(layout.size, device=flat.device)
    aux = torch.empty(AUX_WIDTH, device=flat.device)
    tensors = (flat, obs, act, logp_old, adv, ret, lam, resc, grad, aux)
    tail = (1.0 - eps_clip, 1.0 + eps_clip, vf_coef, kernels.stream_ptr())
    with torch.cuda.device(flat.device):
        if kernel_form(layout) == "tuned":
            n_scratch = lib.fsrl_ppo_grad_scratch_floats(B, D, layout.H, A, K)
            scratch = torch.empty(n_scratch, device=flat.device)
            rc = lib.fsrl_ppo_grad(
                *(x.data_ptr() for x in tensors), scratch.data_ptr(), B, D,
                layout.H, A, K, int(bf16), n_scratch, *tail)
        else:
            dims = (B, D, layout.H, layout.H2, A, K)
            n_scratch = lib.fsrl_ppo_grad_any_scratch_floats(*dims)
            scratch = torch.empty(n_scratch, device=flat.device)
            rc = lib.fsrl_ppo_grad_any(
                *(x.data_ptr() for x in tensors), scratch.data_ptr(), *dims,
                int(bf16), n_scratch, *tail)
    kernels.check(rc, "fused PPO grad kernel")
    kernels.LAUNCHES[launch_name(layout, bf16)] += 1
    if kernel_form(layout) == "any":
        STAGINGS[any_staging(layout, bf16)] += 1
    return grad, aux


ANY_LAUNCHES = ("row kernel", "weight-gradient products", "reduce")


def any_launches(flat, layout: GradLayout, obs, act, logp_old, adv, ret,
                 lam, resc, *, eps_clip: float = 0.2, vf_coef: float = 0.25,
                 bf16: bool = False):
    """The generic form's three launches (:data:`ANY_LAUNCHES`), each as a
    function that runs it alone on the scratch of one whole launch made
    here at the same arguments, for timing them apart. Not counted as
    launches of the kernel; used by nothing on the main path."""
    B, D = obs.shape
    lib = kernels.library()
    grad = torch.empty(layout.size, device=flat.device)
    aux = torch.empty(AUX_WIDTH, device=flat.device)
    dims = (B, D, layout.H, layout.H2, layout.A, layout.K)
    n_scratch = lib.fsrl_ppo_grad_any_scratch_floats(*dims)
    scratch = torch.empty(n_scratch, device=flat.device)
    tensors = (flat, obs, act, logp_old, adv, ret, lam, resc, grad, aux,
               scratch)
    ptrs = [x.data_ptr() for x in tensors]

    def one(which):
        def run(keep=tensors):   # the launches' memory lives with them
            with torch.cuda.device(flat.device):
                rc = lib.fsrl_ppo_grad_any_one(
                    *ptrs, *dims, int(bf16), n_scratch, 1.0 - eps_clip,
                    1.0 + eps_clip, vf_coef, kernels.stream_ptr(), which)
            kernels.check(rc, f"generic K2 launch {which}")
        return run
    for which in range(3):
        with torch.cuda.device(flat.device):
            kernels.check(lib.fsrl_ppo_grad_any_one(
                *ptrs, *dims, int(bf16), n_scratch, 1.0 - eps_clip,
                1.0 + eps_clip, vf_coef, kernels.stream_ptr(), which),
                f"generic K2 launch {which}")
    return [one(which) for which in range(3)]


def reduce_launch(layout: GradLayout, B: int, device="cuda"):
    """The tuned form's last launch alone (the fixed-order sum of the block
    partials) on scratch of the size a batch of ``B`` rows takes, so that it
    can be timed on its own (the generic form's: :func:`any_launches`). The
    scratch is not initialised, so the sums mean nothing; not counted as a
    launch of the kernel."""
    kernels.require(kernel_form(layout) == "tuned",
                    f"reduce_launch times the tuned form; got {layout}")
    lib = kernels.library()
    grad = torch.empty(layout.size, device=device)
    aux = torch.empty(AUX_WIDTH, device=device)
    with torch.cuda.device(grad.device):
        scratch = torch.empty(lib.fsrl_ppo_grad_scratch_floats(
            B, layout.D, layout.H, layout.A, layout.K), device=device)
        rc = lib.fsrl_ppo_grad_reduce_only(
            scratch.data_ptr(), grad.data_ptr(), aux.data_ptr(), B, layout.D,
            layout.A, layout.K, kernels.stream_ptr())
    kernels.check(rc, "fused PPO grad reduce launch")
    return grad, aux


def retake_counts(form: str = "tuned") -> tuple[int, int]:
    """Pre-activations the f32 kernel of ``form`` ("tuned" or "any", as
    :func:`kernel_form` names them) took again in float64 (first layer,
    second layer) since the last call, which clears them; synchronises the
    card. For the card checks, used by nothing on the main path."""
    import ctypes
    out = (ctypes.c_ulonglong * 2)()
    lib = kernels.library()
    fn = (lib.fsrl_ppo_grad_f32_retakes if form == "tuned"
          else lib.fsrl_ppo_grad_any_retakes)
    kernels.check(fn(out), f"f32 retake count ({form})")
    return int(out[0]), int(out[1])


def ppo_grad_rows(flat, layout, obs, act, logp_old, adv, ret, lam, resc, *,
                  eps_clip: float = 0.2, vf_coef: float = 0.25,
                  bf16: bool = False):
    """``(grad, aux_row)`` from the kernel (CUDA) or the plain version
    (CPU)."""
    fn = ppo_grad_plain if flat.device.type == "cpu" else _launch
    return fn(flat, layout, obs, act, logp_old, adv, ret, lam, resc,
              eps_clip=eps_clip, vf_coef=vf_coef, bf16=bf16)


def ppo_grad_minibatch(flat, layout: GradLayout, obs, act, logp_old, adv,
                       ret, lam, resc, *, eps_clip: float = 0.2,
                       vf_coef: float = 0.25, bf16: bool = False):
    """Gradient of the PPO-Lag minibatch loss. ``adv`` must already be
    normalized. Returns ``(loss, aux, grad)``: ``aux`` is the metric dict the
    autograd path produces, ``grad`` the flat gradient."""
    grad, row = ppo_grad_rows(flat, layout, obs, act, logp_old, adv, ret,
                              lam, resc, eps_clip=eps_clip, vf_coef=vf_coef,
                              bf16=bf16)
    B, M = obs.shape[0], layout.K - 1
    kl = row[0] / B
    loss_rew = -row[1] / B
    loss_vf = row[2] / B
    cost_terms = row[3: 3 + M] / B
    loss_actor = resc * (loss_rew + (lam * cost_terms).sum())
    lsig = layout.views(flat)["actor.log_sigma"]
    entropy = (torch.log(torch.exp(lsig)) + 0.5 + LOG_SQRT_2PI).sum()
    aux = dict(loss_actor_rew=loss_rew, loss_actor_total=loss_actor,
               loss_vf_total=loss_vf, kl=kl, entropy=entropy)
    return loss_actor + vf_coef * loss_vf, aux, grad
