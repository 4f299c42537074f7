"""ASP: automatic 2:4 structured sparsity, the counterpart of
``apex_tpu/contrib/sparsity/asp.py``.

Reference: ``reference:apex/contrib/sparsity/asp.py:28-44``:
``init_model_for_pruning`` attaches masks to whitelisted Linear/Conv
weights, ``init_optimizer_for_pruning`` makes ``optimizer.step`` apply
them after every update, and ``compute_sparse_masks`` fills them with the
"m4n2_1d" pattern (``sparse_masklib.py:37-66``: in every group of 4
consecutive weights along the input dim, keep the 2 largest magnitudes).
``ASP(permute=True)`` picks each mask under the channel permutation that
:mod:`apex_tpu_torch.contrib.sparsity.permutation` finds.

Masks are boolean tensors in a tree that mirrors the parameters: a dict
of state-dict names (``dict(model.named_parameters())``) or nested dicts,
lists and tuples of tensors, whose leaves are named by their keys joined
with ``"."``. The default whitelist reads those names: it keeps floating
tensors of two or more dims whose last dim is a multiple of ``m`` and at
least 16, and blocks any name holding ``bias``, ``norm``, ``bn``, ``ln``
or ``embedding``. Masks are ordinary state: save them beside the params
(``torch.save`` keeps them bit for bit).

Ties between magnitudes (zeros, pruned weights, repeated values) are
broken as the JAX package's stable ``argsort`` breaks them: the sort here
is ``stable=True`` too, so the masks agree bit for bit. The masks are
elementwise, as the reference's: no 2:4 semi-structured sparse product is
used. The JAX package leaves all of this to XLA (no Pallas kernel), so the
port runs torch ops.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import torch

__all__ = ["ASP", "compute_sparse_masks", "apply_masks", "mn_1d_mask",
           "sparse_parameter_paths"]


def mn_1d_mask(w: torch.Tensor, m: int = 4, n: int = 2) -> torch.Tensor:
    """n:m mask along the last axis: in every group of ``m`` consecutive
    elements keep the ``n`` largest ``|w|`` (``sparse_masklib.py:37-49``,
    the exact per-group top-n), on ``w``'s device."""
    if w.shape[-1] % m:
        raise ValueError(f"last dim {w.shape[-1]} not divisible by m={m}")
    groups = w.abs().reshape(*w.shape[:-1], w.shape[-1] // m, m)
    order = torch.argsort(groups, dim=-1, stable=True)       # ascending
    ranks = torch.argsort(order, dim=-1, stable=True)
    return (ranks >= m - n).reshape(w.shape)


def _map_named(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """``tree`` with ``fn(name, leaf)`` at every leaf of its dicts, lists
    and tuples, ``name`` the keys joined with ``"."``."""
    def join(key):
        return f"{prefix}.{key}" if prefix else str(key)

    if isinstance(tree, dict):
        return {k: _map_named(fn, v, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(fn, v, join(i))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def _named_leaves(tree: Any) -> List[Tuple[str, Any]]:
    out: List[Tuple[str, Any]] = []
    _map_named(lambda name, leaf: out.append((name, leaf)), tree)
    return out


def _pairs(tree: Any, like: Any) -> Iterator[Tuple[Any, Any]]:
    """``(leaf of tree, leaf of like)`` over ``like``'s structure, dicts
    matched by key (not by order)."""
    if isinstance(like, dict):
        for k, v in like.items():
            yield from _pairs(tree[k], v)
    elif isinstance(like, (list, tuple)):
        for a, b in zip(tree, like):
            yield from _pairs(a, b)
    else:
        yield tree, like


def _default_whitelist(name: str, leaf: Any, m: int) -> bool:
    """The Linear/Conv whitelist by shape and name: floating weights with
    >= 2 dims whose last dim is a multiple of ``m`` and at least 16 (the
    reference skips tiny layers the same way), no blocked word in the
    name."""
    if not (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()):
        return False
    if leaf.ndim < 2 or leaf.shape[-1] % m or leaf.shape[-1] < 16:
        return False
    name = name.lower()
    blocked = ("bias", "norm", "bn", "ln", "embedding")
    return not any(b in name for b in blocked)


def sparse_parameter_paths(params: Any, m: int = 4,
                           whitelist: Optional[Callable] = None
                           ) -> List[str]:
    """The names of the leaves ASP would prune (the role of
    ``__sparse_parameters``)."""
    wl = whitelist or _default_whitelist
    return [name for name, leaf in _named_leaves(params) if wl(name, leaf, m)]


def compute_sparse_masks(params: Any, m: int = 4, n: int = 2,
                         whitelist: Optional[Callable] = None,
                         permute: bool = False, **permute_kw) -> Any:
    """Mask tree: n:m boolean masks for whitelisted leaves, all-True for
    the rest, each on its leaf's device. ``permute=True`` runs the
    channel-permutation search (host numpy) for each whitelisted leaf and
    keeps at least the unpermuted mask's magnitude."""
    wl = whitelist or _default_whitelist

    def one(name, leaf):
        if wl(name, leaf, m):
            if permute:
                from apex_tpu_torch.contrib.sparsity.permutation import (
                    permuted_mn_1d_mask)
                return permuted_mn_1d_mask(leaf.detach(), m, n, **permute_kw)
            return mn_1d_mask(leaf.detach(), m, n)
        return torch.ones(tuple(leaf.shape), dtype=torch.bool,
                          device=leaf.device)

    return _map_named(one, params)


def apply_masks(params: Any, masks: Any) -> Any:
    """A new tree with the pruned entries of every floating leaf zeroed."""
    def rebuild(tree, like):
        if isinstance(like, dict):
            return {k: rebuild(tree[k], v) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            return type(like)(rebuild(a, b) for a, b in zip(tree, like))
        if isinstance(tree, torch.Tensor) and tree.is_floating_point():
            return torch.where(like, tree, tree.new_zeros(()))
        return tree

    return rebuild(params, masks)


def _complements(masks: Any) -> List[torch.Tensor]:
    """Each mask's complement, in ``_pairs`` order (all False for the
    leaves a mask keeps whole, integer ones included)."""
    return [~msk for msk, _ in _pairs(masks, masks)]


def _zero_pruned_(tree: Any, pruned: List[torch.Tensor], masks: Any) -> None:
    """Zero, in place, the pruned entries of ``tree``'s tensors
    (``pruned`` from :func:`_complements`); ``None`` leaves are skipped."""
    for (t, _), off in zip(_pairs(tree, masks), pruned):
        if isinstance(t, torch.Tensor):
            t.masked_fill_(off, 0)


class ASP:
    """The workflow object (``asp.py:28-44``)::

        asp = ASP()
        masks = asp.compute_sparse_masks(params)
        opt = asp.init_optimizer_for_pruning(opt, masks)
        asp.prune(params, masks)           # one-time prune, in place
        ... training; opt.step re-applies the masks every update ...
    """

    def __init__(self, m: int = 4, n: int = 2,
                 whitelist: Optional[Callable] = None,
                 permute: bool = False):
        self.m, self.n = m, n
        self.whitelist = whitelist
        self.permute = permute

    def compute_sparse_masks(self, params: Any, **permute_kw) -> Any:
        return compute_sparse_masks(params, self.m, self.n, self.whitelist,
                                    permute=self.permute, **permute_kw)

    @torch.no_grad()
    def prune(self, params: Any, masks: Any) -> Any:
        """Zero the pruned entries of ``params`` in place; returns
        ``params``."""
        _zero_pruned_(params, _complements(masks), masks)
        return params

    def init_optimizer_for_pruning(self, optimizer: Any, masks: Any) -> Any:
        """Wrap ``optimizer`` so masked entries stay zero after every
        update (the reference's patched ``step``); the grads of pruned
        entries are zeroed first, so no moment accumulates for them."""
        return _MaskedOptimizer(optimizer, masks)


class _MaskedOptimizer:
    """The port's optimizer protocol (``init``; ``step(grads, state,
    params, **kw)`` writing in place) with the masks applied around the
    inner step: the grads' pruned entries zeroed before it, the params'
    after it, in place on the device (no host read). An overflow step
    (``grads_finite`` false) keeps the old params, whose pruned entries are
    already 0."""

    def __init__(self, inner: Any, masks: Any):
        self.inner = inner
        self.masks = masks
        self._pruned = _complements(masks)

    def init(self, params: Any) -> Any:
        return self.inner.init(params)

    @torch.no_grad()
    def step(self, grads: Any, state: Any, params: Any, **kw):
        _zero_pruned_(grads, self._pruned, self.masks)
        params, state = self.inner.step(grads, state, params, **kw)
        _zero_pruned_(params, self._pruned, self.masks)
        return params, state
