"""Channel-permutation search, the accuracy-recovery half of 2:4 ASP: a
copy of ``apex_tpu/contrib/sparsity/permutation.py`` (numpy), with torch
tensors taken and returned.

Reference: ``reference:apex/contrib/sparsity/permutation_lib.py`` (find
input-channel permutations that maximize the magnitude the n:m mask
keeps) and ``permutation_search_kernels/exhaustive_search.py:371``
(bounded exhaustive search over canonical group partitions, and greedy
channel-swap refinement).

Pruning groups are ``m`` consecutive channels along the mask axis; a
permutation that puts channels whose large magnitudes do not collide into
one group raises the retained magnitude ("efficacy"). Two searches:

* **exhaustive** over canonical set partitions of the channels into
  groups of ``m`` (identity included, so never worse), for small channel
  counts;
* **bounded greedy channel swap**: passes over sampled group pairs, each
  applying the best single-channel swap of a pair while it improves (the
  reference's ``Channel_Swap``), with row subsampling to bound the cost.

The permutation lives in mask selection alone: the masks are elementwise,
so nothing is physically permuted, and ``permuted_mn_1d_mask`` returns a
mask in the original channel order whose nonzeros follow the permuted
grouping. The search is host numpy: a tensor on the card is copied to the
host once for it. Every axis but the last is folded into rows, so a
stacked ``(L, out, in)`` array gets one permutation shared by its L
layers, and a single layer's ``(out, in)`` weight its own.
"""

from __future__ import annotations

import itertools
from typing import Any, Optional, Tuple

import numpy as np
import torch

__all__ = ["permutation_efficacy", "search_channel_permutation",
           "exhaustive_partition_search", "greedy_swap_search",
           "permuted_mn_1d_mask"]


def _as_2d(w: Any) -> np.ndarray:
    """``|w|`` in float64 with every axis but the last (the mask axis)
    folded into rows."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().double().numpy()
    w = np.abs(np.asarray(w, np.float64))
    return w.reshape(-1, w.shape[-1])


def _retained(w2d: np.ndarray, m: int, n: int) -> float:
    """Sum of magnitudes kept by the n:m mask over consecutive groups."""
    r, c = w2d.shape
    g = w2d.reshape(r, c // m, m)
    part = np.partition(g, m - n, axis=-1)[..., m - n:]
    return float(part.sum())


def permutation_efficacy(w: Any, perm: np.ndarray,
                         m: int = 4, n: int = 2) -> float:
    """Retained-magnitude sum of the n:m mask after permuting the mask
    axis by ``perm``."""
    return _retained(_as_2d(w)[:, np.asarray(perm)], m, n)


def exhaustive_partition_search(w2d: np.ndarray, m: int, n: int
                                ) -> np.ndarray:
    """Canonical exhaustive search (``exhaustive_search.py:371``): efficacy
    depends only on the partition of channels into groups, so enumerate
    set partitions into blocks of ``m``, identity included."""
    c = w2d.shape[1]

    def partitions(chans):
        if not chans:
            yield []
            return
        first, rest = chans[0], chans[1:]
        for combo in itertools.combinations(rest, m - 1):
            block = (first,) + combo
            remaining = [x for x in rest if x not in combo]
            for p in partitions(remaining):
                yield [block] + p

    best_perm, best_eff = np.arange(c), _retained(w2d, m, n)
    for part in partitions(list(range(c))):
        perm = np.asarray([ch for block in part for ch in block])
        eff = _retained(w2d[:, perm], m, n)
        if eff > best_eff:
            best_perm, best_eff = perm, eff
    return best_perm


def greedy_swap_search(w2d: np.ndarray, m: int, n: int,
                       max_passes: int = 10,
                       pairs_per_pass: Optional[int] = None,
                       seed: int = 0) -> np.ndarray:
    """Bounded greedy channel-swap refinement from identity: per sampled
    pair of groups, apply the best single-channel swap if it raises the
    two groups' retained magnitude; stop after a pass with no
    improvement. Never worse than identity. ``pairs_per_pass`` defaults
    to ``8 * n_groups`` pairs drawn from ``RandomState(seed)`` each pass
    (all pairs when there are fewer)."""
    rng = np.random.RandomState(seed)
    c = w2d.shape[1]
    n_groups = c // m
    if pairs_per_pass is None:
        pairs_per_pass = 8 * n_groups
    perm = np.arange(c)

    def group_eff(cols: np.ndarray) -> float:
        part = np.partition(cols, m - n, axis=-1)[..., m - n:]
        return float(part.sum())

    all_pairs = n_groups * (n_groups - 1) // 2
    for _ in range(max_passes):
        if all_pairs <= pairs_per_pass:
            pairs = [(a, b) for a in range(n_groups)
                     for b in range(a + 1, n_groups)]
            rng.shuffle(pairs)
        else:
            ab = rng.randint(0, n_groups, (2 * pairs_per_pass + 16, 2))
            seen = set()
            pairs = []
            for a, b in ab:
                if a == b:
                    continue
                key = (int(min(a, b)), int(max(a, b)))
                if key in seen:
                    continue
                seen.add(key)
                pairs.append(key)
                if len(pairs) == pairs_per_pass:
                    break
        improved = False
        for a, b in pairs:
            ia = perm[a * m:(a + 1) * m].copy()
            ib = perm[b * m:(b + 1) * m].copy()
            cols_a, cols_b = w2d[:, ia], w2d[:, ib]
            base = group_eff(cols_a) + group_eff(cols_b)
            best_delta, best_swap = 0.0, None
            for i in range(m):
                for j in range(m):
                    na, nb = cols_a.copy(), cols_b.copy()
                    na[:, i], nb[:, j] = cols_b[:, j], cols_a[:, i]
                    delta = group_eff(na) + group_eff(nb) - base
                    if delta > best_delta + 1e-12:
                        best_delta, best_swap = delta, (i, j)
            if best_swap is not None:
                i, j = best_swap
                ia[i], ib[j] = ib[j], ia[i]
                perm[a * m:(a + 1) * m] = ia
                perm[b * m:(b + 1) * m] = ib
                improved = True
        if not improved:
            break
    return perm


def search_channel_permutation(w: Any, m: int = 4, n: int = 2,
                               method: str = "auto",
                               max_rows: int = 512,
                               seed: int = 0,
                               **kw) -> Tuple[np.ndarray, float, float]:
    """A mask-axis permutation maximizing the n:m retained magnitude.

    Returns ``(perm, efficacy_identity, efficacy_permuted)``, the second
    never below the first. ``method``: ``"exhaustive"`` (feasible to ~3
    groups), ``"greedy"``, or ``"auto"`` (exhaustive for <= 2m channels,
    greedy otherwise). Rows past ``max_rows`` are subsampled for the
    search only; the efficacies are measured on every row."""
    w2d_full = _as_2d(w)
    c = w2d_full.shape[1]
    if c % m:
        raise ValueError(f"channels {c} not divisible by m={m}")
    w2d = w2d_full
    if w2d.shape[0] > max_rows:
        rng = np.random.RandomState(seed)
        w2d = w2d[rng.choice(w2d.shape[0], max_rows, replace=False)]
    if method == "auto":
        method = "exhaustive" if c <= 2 * m else "greedy"
    if method == "exhaustive":
        perm = exhaustive_partition_search(w2d, m, n)
    elif method == "greedy":
        perm = greedy_swap_search(w2d, m, n, seed=seed, **kw)
    else:
        raise ValueError(f"unknown method {method!r}")
    eff_id = _retained(w2d_full, m, n)
    eff_perm = _retained(w2d_full[:, perm], m, n)
    if eff_perm < eff_id:  # a subsampled search can lose on every row
        return np.arange(c), eff_id, eff_id
    return perm, eff_id, eff_perm


def permuted_mn_1d_mask(w: torch.Tensor, m: int = 4, n: int = 2,
                        **search_kw) -> torch.Tensor:
    """n:m mask in the original channel order whose nonzeros follow the
    best permuted grouping found, on ``w``'s device: its retained
    magnitude is at least the unpermuted mask's."""
    from apex_tpu_torch.contrib.sparsity.asp import mn_1d_mask

    perm, _, _ = search_channel_permutation(w, m, n, **search_kw)
    perm_t = torch.as_tensor(perm, device=w.device)
    mp = mn_1d_mask(w.index_select(-1, perm_t), m, n)
    inv = torch.as_tensor(np.argsort(perm), device=w.device)
    return mp.index_select(-1, inv)
