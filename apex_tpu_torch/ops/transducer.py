"""RNN-T (transducer) joint and loss, the counterpart of
``apex_tpu/ops/transducer.py``.

Reference: ``reference:apex/contrib/csrc/transducer/
transducer_joint_kernel.cu`` (the f + g broadcast add with a fused ReLU and
dropout) and ``transducer_loss_kernel.cu`` (the alpha/beta recursion and
the fused log-softmax backward), with the host semantics of
``reference:apex/contrib/test/transducer/transducer_ref.py``. The JAX
package leaves both to XLA (no Pallas kernel), so the port runs them as
torch ops.

- **Joint**: ``h[b, t, u] = f[b, t] + g[b, u]``, then ReLU, then inverted
  dropout drawn from a ``torch.Generator`` (the reference's keep rate,
  scaling and zeroed cells; not its ``jax.random`` bits), then the padded
  cells (``t >= f_len`` or ``u >= g_len``) zeroed. ``pack_output`` is not
  reproduced, as in the reference: the padded layout stays.
- **Loss**: the transition log-probs are masked on the full ``(T, U+1)``
  grid with ``_NEG = -1e30`` (never ``-inf``: ``exp(common + ...)`` of a
  masked cell must be 0, not NaN), and the terminal blank at ``(f_len-1,
  y_len)`` enters beta as a boundary reward, as in the reference. alpha
  and beta are solved along anti-diagonals ``t + u = k``: every cell of a
  diagonal depends only on the diagonal before it, so the recursion takes
  ``T + U`` sequential steps, each one vectorized log-add-exp over the
  batch and the diagonal (the reference solves each row with an
  associative scan inside a scan over T; the association order of the
  log-add-exps differs, the recurrence does not).
- **Backward**: a ``torch.autograd.Function`` whose backward is the
  reference's closed form (``_loss_bwd``: the alpha+beta gradient fused
  with the log-softmax backward), not autograd through the recursion. It
  keeps ``x_log`` and O(B T U) state. The reference's gradient is fp32
  whatever ``x``'s dtype; torch casts a gradient to its input's dtype, so
  for a bf16 ``x`` the port's is that fp32 gradient rounded once to bf16.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["transducer_joint", "transducer_loss", "TransducerJoint",
           "TransducerLoss"]

_NEG = -1e30


def transducer_joint(f: torch.Tensor, g: torch.Tensor,
                     f_len: Optional[torch.Tensor] = None,
                     g_len: Optional[torch.Tensor] = None,
                     relu: bool = False, dropout_rate: float = 0.0,
                     generator: Optional[torch.Generator] = None
                     ) -> torch.Tensor:
    """``h[b, t, u, :] = f[b, t, :] + g[b, u, :]`` with optional ReLU and
    dropout. ``f``: (B, T, H) encoder; ``g``: (B, U, H) predictor; returns
    (B, T, U, H) with the padded cells zeroed. Dropout needs a
    ``generator`` on the inputs' device."""
    h = f[:, :, None, :] + g[:, None, :, :]
    if relu:
        h = torch.relu(h)
    if dropout_rate > 0.0:
        if generator is None:
            raise ValueError("dropout_rate > 0 requires a generator")
        keep = torch.rand(h.shape, generator=generator,
                          device=h.device) < 1.0 - dropout_rate
        h = torch.where(keep, h / (1.0 - dropout_rate), h.new_zeros(()))
    ok = None
    if f_len is not None:
        ok = (torch.arange(h.shape[1], device=h.device)[None, :, None]
              < f_len.to(h.device)[:, None, None])
    if g_len is not None:
        u_ok = (torch.arange(h.shape[2], device=h.device)[None, None, :]
                < g_len.to(h.device)[:, None, None])
        ok = u_ok if ok is None else ok & u_ok
    if ok is not None:
        h = torch.where(ok[..., None], h, h.new_zeros(()))
    return h


def _label_logp(x_log: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """``x_log[b, t, u, label[b, u]]`` for ``u < U``: (B, T, U)."""
    B, T, U1, _ = x_log.shape
    idx = label.long()[:, None, :, None].expand(B, T, U1 - 1, 1)
    return torch.gather(x_log[:, :, :U1 - 1], -1, idx)[..., 0]


def _prep(x_log, label, f_len, y_len, blank_idx):
    """Masked transition log-probs on the full (T, U+1) grid: blank
    transitions valid for ``t <= f_len-2``, label transitions for ``t <=
    f_len-1`` and ``u <= y_len-1``, and ``term``, the terminal blank at
    ``(f_len-1, y_len)``; ``_NEG`` elsewhere."""
    B, T, U1, _ = x_log.shape
    dev = x_log.device
    x_blank = x_log[..., blank_idx]
    lab = F.pad(_label_logp(x_log, label), (0, 1), value=_NEG)
    t_idx = torch.arange(T, device=dev)[None, :, None]
    u_idx = torch.arange(U1, device=dev)[None, None, :]
    fl = f_len.to(dev)[:, None, None]
    yl = y_len.to(dev)[:, None, None]
    neg = x_log.new_full((), _NEG)
    blank_m = torch.where(t_idx <= fl - 2, x_blank, neg)
    lab_m = torch.where((t_idx <= fl - 1) & (u_idx <= yl - 1), lab, neg)
    term = torch.where((t_idx == fl - 1) & (u_idx == yl), x_blank, neg)
    return blank_m, lab_m, term


class _Diagonals:
    """Index maps between the (B, T, U1) grid and its anti-diagonals,
    stored (K, B, T) with ``K = T + U1 - 1``: ``skew[k, b, t] =
    grid[b, t, k - t]``."""

    def __init__(self, T: int, U1: int, device):
        K = T + U1 - 1
        k = torch.arange(K, device=device)[:, None]
        t = torch.arange(T, device=device)[None, :]
        u = k - t
        self.valid = (u >= 0) & (u < U1)
        self.t_of = t.expand(K, T)
        self.u_of = u.clamp(0, U1 - 1)
        tt = torch.arange(T, device=device)[:, None]
        uu = torch.arange(U1, device=device)[None, :]
        self.k_of = tt + uu
        self.t_grid = tt.expand(T, U1)

    def skew(self, grid: torch.Tensor) -> torch.Tensor:
        s = grid[:, self.t_of, self.u_of]                # (B, K, T)
        s = torch.where(self.valid, s, grid.new_full((), _NEG))
        return s.permute(1, 0, 2).contiguous()

    def unskew(self, diag: torch.Tensor) -> torch.Tensor:
        return diag[self.k_of, :, self.t_grid].permute(2, 0, 1)


def _forward_alpha(blank_s, lab_s) -> torch.Tensor:
    """alpha[t, u] = LSE(alpha[t-1, u] + blank_m[t-1, u],
    alpha[t, u-1] + lab_m[t, u-1]); alpha[0, 0] = 0. On diagonal k, the
    first term comes from index t-1 of diagonal k-1, the second from
    index t."""
    K, B, T = blank_s.shape
    d = blank_s.new_full((K, B, T), _NEG)
    d[0, :, 0] = 0.0
    for k in range(1, K):
        prev = d[k - 1]
        move_u = prev + lab_s[k - 1]
        move_t = prev[:, :-1] + blank_s[k - 1, :, :-1]
        d[k, :, 0] = move_u[:, 0]
        torch.logaddexp(move_u[:, 1:], move_t, out=d[k, :, 1:])
    return d


def _backward_beta(blank_s, lab_s, term_s) -> torch.Tensor:
    """beta[t, u] = LSE(LSE(term[t, u], beta[t+1, u] + blank_m[t, u]),
    beta[t, u+1] + lab_m[t, u]). On diagonal k, beta[t+1, u] is index t+1
    of diagonal k+1 and beta[t, u+1] index t."""
    K, B, T = blank_s.shape
    e = blank_s.new_full((K + 1, B, T), _NEG)
    for k in range(K - 1, -1, -1):
        nxt = e[k + 1]
        base = e[k]
        base.copy_(term_s[k])
        torch.logaddexp(base[:, :-1], nxt[:, 1:] + blank_s[k, :, :-1],
                        out=base[:, :-1])
        torch.logaddexp(base, nxt + lab_s[k], out=base)
    return e[:K]


def _alpha_beta(x, label, f_len, y_len, blank_idx):
    x_log = torch.log_softmax(x.float(), dim=-1)
    blank_m, lab_m, term = _prep(x_log, label, f_len, y_len, blank_idx)
    B, T, U1 = blank_m.shape
    dg = _Diagonals(T, U1, x.device)
    blank_s, lab_s, term_s = (dg.skew(a) for a in (blank_m, lab_m, term))
    alpha = dg.unskew(_forward_alpha(blank_s, lab_s))
    beta = dg.unskew(_backward_beta(blank_s, lab_s, term_s))
    return x_log, alpha, beta


class _TransducerLoss(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, label, f_len, y_len, blank_idx):
        x_log, alpha, beta = _alpha_beta(x, label, f_len, y_len, blank_idx)
        ctx.save_for_backward(x_log, alpha, beta, label, f_len, y_len)
        ctx.blank_idx = blank_idx
        return (-beta[:, 0, 0]).to(x.dtype)

    @staticmethod
    def backward(ctx, loss_grad):
        x_log, alpha, beta, label, f_len, y_len = ctx.saved_tensors
        return (_loss_bwd(x_log, alpha, beta, label, f_len, y_len,
                          ctx.blank_idx, loss_grad), None, None, None, None)


def _loss_bwd(x_log, alpha, beta, label, f_len, y_len, blank_idx,
              loss_grad):
    """The analytic gradient (``transducer_ref.py:47-66``) fused with the
    log-softmax backward: ``dx = g - softmax(x) * sum_v g``, where ``g``,
    the gradient with respect to ``x_log``, is nonzero only at the blank
    and at each cell's label."""
    B, T, U1, V = x_log.shape
    dev = x_log.device
    common = alpha - beta[:, 0, 0][:, None, None]
    t_idx = torch.arange(T, device=dev)[None, :, None]
    u_idx = torch.arange(U1, device=dev)[None, None, :]
    fl = f_len.to(dev)[:, None, None]
    yl = y_len.to(dev)[:, None, None]
    zero = x_log.new_zeros(())

    x_blank = x_log[..., blank_idx]
    lab = _label_logp(x_log, label)
    beta_next_u = beta[:, :, 1:]
    g_lab = -torch.exp(common[:, :, :U1 - 1] + beta_next_u + lab)
    g_lab = torch.where((t_idx <= fl - 1) & (u_idx[:, :, :U1 - 1] <= yl - 1),
                        g_lab, zero)
    beta_next_t = F.pad(beta[:, 1:], (0, 0, 0, 1), value=_NEG)
    g_blank = -torch.exp(common + beta_next_t + x_blank)
    g_blank = torch.where((t_idx <= fl - 2) & (u_idx <= yl), g_blank, zero)
    g_term = -torch.exp(common + x_blank)
    g_term = torch.where((t_idx == fl - 1) & (u_idx == yl), g_term, zero)
    g_blank = g_blank + g_term

    lg = loss_grad.float()[:, None, None]
    g_blank = g_blank * lg
    g_lab = g_lab * lg
    gsum = g_blank + F.pad(g_lab, (0, 1))
    dx = torch.exp(x_log).mul_(gsum[..., None]).neg_()
    dx[..., blank_idx] += g_blank
    idx = label.long()[:, None, :, None].expand(B, T, U1 - 1, 1)
    dx[:, :, :U1 - 1].scatter_add_(-1, idx, g_lab[..., None])
    return dx


def transducer_loss(x: torch.Tensor, label: torch.Tensor,
                    f_len: torch.Tensor, y_len: torch.Tensor,
                    blank_idx: int = 0) -> torch.Tensor:
    """Per-sequence RNN-T negative log-likelihood, shape (B,), in ``x``'s
    dtype. ``x``: (B, T, U+1, V) joint logits (not log-softmaxed: the
    log-softmax is fused); ``label``: (B, U) int targets; ``f_len`` and
    ``y_len``: per-sequence valid lengths, on ``x``'s device."""
    return _TransducerLoss.apply(x, label, f_len, y_len, blank_idx)


class TransducerJoint:
    """Module-shaped wrapper (``reference:apex/contrib/transducer/
    transducer.py:5-66``); ``pack_output=True`` raises."""

    def __init__(self, pack_output: bool = False, relu: bool = False,
                 dropout: bool = False, dropout_prob: float = 0.0):
        if pack_output:
            raise NotImplementedError(
                "pack_output=True is a memory-layout optimization of the "
                "CUDA reference; keep the padded layout and mask the loss")
        self.relu = relu
        self.dropout = dropout
        self.dropout_prob = dropout_prob

    def __call__(self, f, g, f_len=None, g_len=None, generator=None):
        rate = self.dropout_prob if self.dropout else 0.0
        return transducer_joint(f, g, f_len, g_len, relu=self.relu,
                                dropout_rate=rate, generator=generator)


class TransducerLoss:
    """Module-shaped wrapper (``transducer.py:68-125``); the fused
    log-softmax backward is always on. ``packed_input=True`` raises."""

    def __init__(self, packed_input: bool = False):
        if packed_input:
            raise NotImplementedError(
                "packed_input=True is a memory-layout optimization of the "
                "CUDA reference; feed the padded (B, T, U+1, V) joint "
                "output")

    def __call__(self, x, label, f_len, y_len, blank_idx: int = 0):
        return transducer_loss(x, label, f_len, y_len, blank_idx)
