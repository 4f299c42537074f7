"""Model-parallel RNG streams and activation checkpointing, the
counterpart of ``apex_tpu/transformer/tensor_parallel/random.py``.

Reference: ``reference:apex/transformer/tensor_parallel/random.py`` --
``CudaRNGStatesTracker`` (:120-193) keeps named RNG states so that
tensor-parallel ranks share a "model-parallel" stream while data-parallel
ranks keep distinct ones; ``model_parallel_cuda_manual_seed`` (:200-230)
seeds them ``seed + 2718 + tp_rank`` and ``seed``; ``CheckpointFunction``
(:233-304) recomputes in the backward with the forward's RNG.

The JAX package keeps named ``PRNGKey`` streams and ``fork`` hands out a
fresh split. The port keeps named ``torch.Generator`` streams on a stated
device (the card unless the caller passes ``device="cpu"``; with no card a
CUDA stream raises when it is made), and
:meth:`RNGStatesTracker.make_key` hands out a fresh generator
split off a stream by a fixed derivation: it draws one seed from the
stream (an int64 in ``[0, 2**62)``, one ``torch.randint`` on the stream's
generator, which advances it) and seeds a new generator on the stream's
device with it. On a card that draw is read back to the host: one
synchronizing read a fork.

``model_parallel_seed(seed, tensor_rank, data_rank)`` seeds the default
stream with ``seed`` and the model-parallel stream with ``seed + 2718 +
tensor_rank``, as the reference does; ``tensor_rank`` defaults to this
rank's tensor rank when a mesh is installed
(:mod:`~apex_tpu_torch.transformer.parallel_state`), else 0. The JAX package folds ``data_rank``
into the default stream with ``fold_in``; the port seeds it with
``(seed + (data_rank + 1) * 0x9E3779B97F4A7C15) mod 2**63`` (a
golden-ratio stride, distinct for every rank). The streams' bits differ
from the JAX package's; the semantics (distinct streams per rank, the same
stream from the same seed, replay through ``get_states``/``set_states``)
hold.

:func:`checkpoint` recomputes a function in the backward with the same
dropout: it is :class:`apex_tpu_torch.remat.RematPolicy` ``full``, which
hands the recompute clones of the generators passed as arguments as they
stood at the function's entry. Pass the forked generator as an argument.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.remat import RematPolicy

__all__ = [
    "RNGStatesTracker", "get_rng_tracker", "model_parallel_seed",
    "checkpoint", "_MODEL_PARALLEL_RNG_TRACKER_NAME",
]

_MODEL_PARALLEL_RNG_TRACKER_NAME = "model-parallel-rng"
_TENSOR_SEED_OFFSET = 2718  # reference:tensor_parallel/random.py:200-230
_DATA_RANK_STRIDE = 0x9E3779B97F4A7C15
_SEED_BOUND = 2 ** 62


class RNGStatesTracker:
    """Named generator streams (``random.py:120-193``) on ``device``.
    ``fork(name)`` yields a fresh generator each call and advances the
    stream. ``device`` is resolved where a stream is made, so a tracker
    on ``"cuda"`` with no card raises at its first ``add``."""

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.states_: Dict[str, torch.Generator] = {}

    def reset(self) -> None:
        self.states_ = {}

    def get_states(self) -> Dict[str, torch.Tensor]:
        """Each stream's state (a copy; ``set_states`` restores it)."""
        return {name: g.get_state() for name, g in self.states_.items()}

    def set_states(self, states: Dict[str, torch.Tensor]) -> None:
        self.states_ = {}
        for name, state in states.items():
            g = torch.Generator(device=resolve_device(self.device))
            g.set_state(state)
            self.states_[name] = g

    def add(self, name: str, seed) -> None:
        """A stream seeded with the int ``seed``, or the generator
        ``seed`` itself; a name that exists raises."""
        if name in self.states_:
            raise Exception(f"rng state {name} already exists")
        if isinstance(seed, torch.Generator):
            self.states_[name] = seed
        else:
            g = torch.Generator(device=resolve_device(self.device))
            g.manual_seed(int(seed))
            self.states_[name] = g

    def make_key(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME
                 ) -> torch.Generator:
        """A new generator split off stream ``name``, which advances."""
        if name not in self.states_:
            raise Exception(f"rng state {name} is not added")
        stream = self.states_[name]
        seed = int(torch.randint(0, _SEED_BOUND, (), generator=stream,
                                 device=stream.device))
        child = torch.Generator(device=stream.device)
        child.manual_seed(seed)
        return child

    @contextlib.contextmanager
    def fork(self, name: str = _MODEL_PARALLEL_RNG_TRACKER_NAME):
        """The reference's context manager (``random.py:171-193``); yields
        the generator to pass to dropout."""
        yield self.make_key(name)


_GLOBAL_TRACKER = RNGStatesTracker()


def get_rng_tracker() -> RNGStatesTracker:
    """``get_cuda_rng_tracker`` equivalent."""
    return _GLOBAL_TRACKER


def model_parallel_seed(seed: int, tensor_rank: Optional[int] = None,
                        data_rank: Optional[int] = None,
                        device="cuda") -> None:
    """``model_parallel_cuda_manual_seed`` (:200-230): resets the global
    tracker onto ``device`` with the default stream at ``seed`` (or the
    ``data_rank`` derivation of the module docstring) and the
    model-parallel stream at ``seed + 2718 + tensor_rank`` (by default
    the installed mesh's tensor rank)."""
    device = resolve_device(device)
    if tensor_rank is None:
        from apex_tpu_torch.transformer import parallel_state
        tensor_rank = (parallel_state.get_tensor_model_parallel_rank()
                       if parallel_state.model_parallel_is_initialized()
                       else 0)
    tracker = get_rng_tracker()
    tracker.reset()
    tracker.device = device
    base = seed
    if data_rank is not None:
        base = (seed + (int(data_rank) + 1) * _DATA_RANK_STRIDE) % 2 ** 63
    tracker.add("default", base)
    tracker.add(_MODEL_PARALLEL_RNG_TRACKER_NAME,
                seed + _TENSOR_SEED_OFFSET + int(tensor_rank))


def checkpoint(function: Callable) -> Callable:
    """``function`` recomputed in the backward with the forward's dropout:
    :class:`~apex_tpu_torch.remat.RematPolicy` ``full`` around it (the
    JAX package's ``jax.checkpoint``)."""
    return RematPolicy(mode="full").wrap(function)
