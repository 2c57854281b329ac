"""Learned (neural) normalized min-sum: differentiable unrolled decoding
and weight training on the decoder's device.

Counterpart of ``myldpccppapi_tpu/ops/learned.py``.  A small schedule
``alpha[t, layer]`` / ``beta[t, layer]`` of min-sum weights is trained by
gradient descent through T unrolled sweeps: autograd through
:func:`make_unrolled` and ``torch.optim.Adam`` take the place of
``jax.grad`` and optax.  The trained schedule drops into
``DecoderConfig.normalization``/``offset`` through
:meth:`LearnedWeights.decoder_config`: tied or per-layer schedules
(``per_layer=True``) run on the kernels (csrc/bp_layered.cu,
csrc/bp_long.cu), whose tables hold one weight per layer; full
per-iteration schedules run on the torch path (ops/bp.py), to which
``Decoder``'s ``"auto"`` sends them on the card as on the CPU, as the
reference's sends them to its jnp path.

The unrolled sweep is ops/bp.py's, written so that autograd sees every
step and nothing it needs is changed in place: the posterior is a list of
``n_b`` block tensors whose entries are replaced, as the reference's
``post.at[j].add`` returns a new array.  Its gradients follow JAX's tie
rules, so that the port's gradients are the reference's:

* the min over a row's magnitudes is ``torch.amin``, which splits the
  gradient evenly among tied minima as ``jnp.min`` does (``torch.min(dim=)``
  would send all of it to one index);
* ``max(mag - beta, 0)`` and the 1e30 clamp are ``torch.maximum`` and
  ``torch.minimum``, which split the gradient at equality as JAX's
  ``max``/``min`` do (``clamp`` does not);
* ``|q|`` passes the gradient ``g`` where q >= 0 and ``-g`` elsewhere, as
  JAX's ``abs`` does (torch's ``abs`` passes 0 at q = 0);
* ``max(mag - beta, 0) * alpha`` is applied even at beta = 0, the
  reference's traced form (``myldpccppapi_tpu/ops/bp.py:131``).

Training uses the all-zero codeword by default (min-sum is symmetric under
the channel's sign flips, so the error probability does not depend on the
codeword); ``encode_fn`` trains on random codewords instead.  The loss is
the mean soft BER (sigmoid cross-entropy of the posterior margins) over all
T iteration outputs.  Every random draw comes from one ``torch.Generator``
seeded by ``seed`` on the trainer's device: in each step the info bits
(with ``encode_fn``), then the per-frame SNR, then the noise.  The
reference draws from threefry keys, so the two trainers see other
batches; :func:`train_step` on the same batches is held against the
reference's step.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..codes.qc import QCCode
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .bp import _Q_INF, _aligners, _layers

__all__ = ["LearnedWeights", "make_unrolled", "soft_ber_loss", "train_nms",
           "train_step"]


class _Abs(torch.autograd.Function):
    """``|x|`` whose gradient is ``g`` where x >= 0 and ``-g`` elsewhere
    (JAX's ``abs`` rule; torch's gives 0 at x = 0)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.abs()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def _check_update(qs: torch.Tensor, alpha: torch.Tensor, beta: torch.Tensor,
                  q_inf: torch.Tensor, zero: torch.Tensor) -> torch.Tensor:
    """The min-sum check update of ``myldpccppapi_tpu/ops/bp.py::
    _check_update_minsum`` with traced weights, differentiable with JAX's
    tie rules (module docstring).  ``qs``: [deg, z, B]; ``alpha``,
    ``beta`` and the constants ``q_inf`` (1e30) and ``zero``: 0-d
    tensors."""
    a = _Abs.apply(qs)
    neg = (qs < 0).to(torch.int32)
    m1 = a.amin(dim=0)
    # the first index of the minimum, as jnp.argmin
    am = torch.argmin(a, dim=0)
    idx = torch.arange(qs.shape[0], device=qs.device).view(-1, 1, 1)
    is_min = idx == am.unsqueeze(0)
    m2 = torch.where(is_min, torch.inf, a).amin(dim=0)
    mag = torch.where(is_min, m2.unsqueeze(0), m1.unsqueeze(0))
    # weight-1 rows: the excluding-self min over nothing is inf
    mag = torch.minimum(mag, q_inf)
    mag = torch.maximum(mag - beta, zero) * alpha
    sign_excl = (neg.sum(dim=0) & 1).unsqueeze(0) ^ neg
    return torch.where(sign_excl == 1, -mag, mag)


def make_unrolled(code: QCCode, n_iters: int, schedule: str = "layered"):
    """Differentiable fixed-budget min-sum decoder.

    Returns ``run(params, llr) -> posteriors [T, B, n]``, where ``params``
    holds ``alpha`` and ``beta`` tensors of shape [T', n_layers] (a first
    dim of 1 ties the weights across iterations, the kernel-servable
    per-layer form; iterations past T' reuse the last row) and ``llr`` is
    [B, n] float32.  No early exit, no latching: every iteration's
    posterior is an output.  The sweeps are ops/bp.py's layered and
    flooding ones (``myldpccppapi_tpu/ops/learned.py:76-115``), so the
    posteriors are bit-exact with the reference's on the same params."""
    if schedule not in ("layered", "flooding"):
        raise ValueError(f"unknown schedule {schedule!r}")
    layers = _layers(code)
    n_b, z = code.n_b, code.z
    row_align, col_align = _aligners(code)
    masks = {}  # per device: {edge: [z, 1] bool live rows}

    def live(dev):
        if dev not in masks:
            masks[dev] = {e: torch.as_tensor(mask[:, None], device=dev)
                          for (_, entries) in layers
                          for (e, _, _, mask) in entries if mask is not None}
        return masks[dev]

    def gather_q(post, r, entries, m):
        qs = []
        for (e, j, s, _) in entries:
            q = row_align(post[j], s) - r[e]
            if e in m:
                q = torch.where(m[e], q, _Q_INF)
            qs.append(q)
        return torch.stack(qs)

    def run(params, llr: torch.Tensor) -> torch.Tensor:
        alpha_p, beta_p = params["alpha"], params["beta"]
        a_rows, b_rows = alpha_p.shape[0], beta_p.shape[0]
        bsz = llr.shape[0]
        m = live(llr.device)
        consts = (llr.new_full((), _Q_INF), llr.new_zeros(()))
        chan = list(llr.t().reshape(n_b, z, bsz).unbind(0))
        post = list(chan)
        r = [torch.zeros_like(chan[0])] * code.num_blocks
        outs = []
        for t in range(n_iters):
            ta, tb = min(t, a_rows - 1), min(t, b_rows - 1)
            if schedule == "layered":
                for li, (_, entries) in enumerate(layers):
                    rn = _check_update(gather_q(post, r, entries, m),
                                       alpha_p[ta, li], beta_p[tb, li], *consts)
                    for idx, (e, j, s, _) in enumerate(entries):
                        delta = rn[idx] - r[e]
                        if e in m:
                            delta = torch.where(m[e], delta, 0.0)
                        post[j] = post[j] + col_align(delta, s)
                        r[e] = rn[idx]
            else:
                rn_all = [_check_update(gather_q(post, r, entries, m),
                                        alpha_p[ta, li], beta_p[tb, li], *consts)
                          for li, (_, entries) in enumerate(layers)]
                post = list(chan)
                for (_, entries), rn in zip(layers, rn_all):
                    for idx, (e, j, s, _) in enumerate(entries):
                        contrib = rn[idx]
                        if e in m:
                            contrib = torch.where(m[e], contrib, 0.0)
                        post[j] = post[j] + col_align(contrib, s)
                        r[e] = rn[idx]
            outs.append(torch.stack(post).reshape(n_b * z, bsz).t())
        return torch.stack(outs)  # [T, B, n]

    return run


def soft_ber_loss(posteriors: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Mean sigmoid cross-entropy of the posterior LLR margins over all
    iteration outputs.  ``posteriors``: [T, B, n] (positive => bit 0);
    ``bits``: [B, n] true 0/1.  softplus is ``logaddexp(x, 0)``, the form
    of ``jax.nn.softplus`` (``F.softplus``'s threshold and ``log1p(exp(x))``
    round otherwise)."""
    tgt = 1.0 - 2.0 * bits.to(posteriors.dtype)  # +1 for bit 0
    x = -tgt.unsqueeze(0) * posteriors
    return torch.logaddexp(x, torch.zeros_like(x)).mean()


@dataclasses.dataclass(frozen=True)
class LearnedWeights:
    """A trained weight schedule plus its conversion helpers."""

    alpha: np.ndarray          #: [T, n_layers]
    beta: np.ndarray           #: [T, n_layers]
    losses: Tuple[float, ...]  #: per-step training losses

    @property
    def n_iters(self) -> int:
        return self.alpha.shape[0]

    def config_values(self, per_layer: bool = False):
        """(normalization, offset) values for DecoderConfig.

        ``per_layer=True`` collapses the schedule to its iteration mean,
        one weight per layer, which the kernels serve; the default keeps
        the full per-iteration schedule (the torch path)."""
        if per_layer:
            a = tuple(float(x) for x in self.alpha.mean(axis=0))
            b_l = self.beta.mean(axis=0)
            b = 0.0 if not b_l.any() else tuple(float(x) for x in b_l)
            return a, b
        a = tuple(tuple(float(x) for x in row) for row in self.alpha)
        if not self.beta.any():
            return a, 0.0
        return a, tuple(tuple(float(x) for x in row) for row in self.beta)

    def decoder_config(self, base=None, per_layer: bool = False, **overrides):
        """A DecoderConfig carrying this schedule (replaced on ``base``)."""
        from ..utils.config import DecoderConfig

        a, b = self.config_values(per_layer)
        base = base if base is not None else DecoderConfig()
        return dataclasses.replace(base, normalization=a, offset=b, **overrides)


def train_step(params: dict, opt: torch.optim.Optimizer, run, llr: torch.Tensor,
               cw: torch.Tensor, *, train_offset: bool = False,
               reg_to_init: float = 0.0, init_alpha: float = 0.75,
               init_beta: float = 0.0) -> torch.Tensor:
    """One training step on one batch (the body of the reference's jitted
    ``step``, ``myldpccppapi_tpu/ops/learned.py:233-256``): the loss of
    ``run`` (:func:`make_unrolled`) on ``llr`` against codewords ``cw``,
    beta held fixed unless ``train_offset``, the optional L2 pull to the
    init, one ``opt`` step, then alpha clipped to [0.05, 1] and beta to
    [0, 2] in place.  Returns the step's loss (before the update), 0-d."""
    opt.zero_grad(set_to_none=True)
    beta = params["beta"] if train_offset else params["beta"].detach()
    loss = soft_ber_loss(run({"alpha": params["alpha"], "beta": beta}, llr), cw)
    if reg_to_init:
        loss = loss + reg_to_init * (
            torch.square(params["alpha"] - init_alpha).mean()
            + torch.square(beta - init_beta).mean())
    loss.backward()
    opt.step()
    with torch.no_grad():
        params["alpha"].clamp_(0.05, 1.0)
        params["beta"].clamp_(0.0, 2.0)
    return loss.detach()


def train_nms(
    code: QCCode,
    *,
    n_iters: int = 8,
    steps: int = 200,
    batch: int = 128,
    snr_db: Tuple[float, float] = (1.0, 4.0),
    lr: float = 0.02,
    seed: int = 0,
    schedule: str = "layered",
    train_offset: bool = False,
    init_alpha: float = 0.75,
    init_beta: float = 0.0,
    encode_fn=None,
    log_every: int = 0,
    tie_iters: bool = False,
    reg_to_init: float = 0.0,
    device=DEFAULT_DEVICE,
) -> LearnedWeights:
    """Train per-iteration x per-layer min-sum weights for ``code`` on
    ``device`` (the card unless ``device="cpu"``).

    Each step draws a fresh batch: per-frame SNR uniform over ``snr_db``
    (train across the waterfall, not one point), LLRs of 2y/sigma^2, the
    all-zero codeword unless ``encode_fn`` (info bits [batch, k] uint8 ->
    codewords [batch, n]) gives random ones.  Adam with optax.adam's
    defaults (betas 0.9, 0.999, eps 1e-8); after each step alpha is clipped
    to [0.05, 1] and beta to [0, 2].  ``tie_iters`` trains one weight row
    shared by every iteration (the per-layer form the kernels serve);
    ``reg_to_init`` adds an L2 pull toward the init."""
    dev = resolve_device(device)
    run = make_unrolled(code, n_iters, schedule)
    rows = 1 if tie_iters else n_iters
    params = {
        "alpha": torch.full((rows, code.m_b), init_alpha, dtype=torch.float32,
                            device=dev, requires_grad=True),
        "beta": torch.full((rows, code.m_b), init_beta, dtype=torch.float32,
                           device=dev, requires_grad=True),
    }
    opt = torch.optim.Adam([params["alpha"], params["beta"]], lr=lr,
                           betas=(0.9, 0.999), eps=1e-8)
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = snr_db

    def sample():
        if encode_fn is None:
            cw = torch.zeros((batch, code.n), dtype=torch.float32, device=dev)
        else:
            u = torch.randint(0, 2, (batch, code.k), generator=gen, device=dev,
                              dtype=torch.uint8)
            cw = torch.as_tensor(encode_fn(u), device=dev).to(torch.float32)
        snr = lo + (hi - lo) * torch.rand((batch, 1), generator=gen, device=dev)
        sigma = 10.0 ** (-snr / 20.0)
        y = (1.0 - 2.0 * cw) + sigma * torch.randn((batch, code.n), generator=gen,
                                                   device=dev)
        return 2.0 * y / torch.square(sigma), cw

    losses = []
    for i in range(steps):
        llr, cw = sample()
        loss = train_step(params, opt, run, llr, cw, train_offset=train_offset,
                          reg_to_init=reg_to_init, init_alpha=init_alpha,
                          init_beta=init_beta)
        losses.append(float(loss))
        if log_every and (i + 1) % log_every == 0:
            print(f"[train_nms] step {i + 1}/{steps} loss {losses[-1]:.5f}")
    return LearnedWeights(
        alpha=params["alpha"].detach().cpu().numpy(),
        beta=params["beta"].detach().cpu().numpy(),
        losses=tuple(losses),
    )
