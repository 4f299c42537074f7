"""``apex.RNN`` for the port: the counterpart of ``apex_tpu/RNN/__init__.py``.

Reference surface: ``reference:apex/RNN/__init__.py:1`` exports the
``LSTM, GRU, ReLU, Tanh, mLSTM`` factories (``models.py:19-53``) over
``stackedRNN``/``bidirectionalRNN``/``RNNCell`` (``RNNBackend.py:25, 90,
232``) and the multiplicative LSTM cell (``cells.py:55``): torch's LSTM,
GRU and Elman cells, plus ``m = (x @ Wmih^T) * (h @ Wmhh^T); gates = x @
Wih^T + m @ Whh^T + b``.

One ``nn.Module``, :class:`ApexRNN`, with the JAX package's parameter
names: a ``ParameterDict`` per layer and direction, ``l{layer}`` and
``l{layer}_rev``, holding ``w_ih``, ``w_hh``, ``b_ih``, ``b_hh`` (with
``bias``), ``w_mih``, ``w_mhh`` (mLSTM) and ``w_ho`` (the ``output_size``
projection), drawn uniform in ``+-1/sqrt(hidden)`` by :meth:`ApexRNN.init`
(:func:`apex_tpu_torch._bridge.rnn_params_from_jax` loads the JAX
package's). The JAX package leaves the RNN to XLA (no Pallas kernel), so
the port runs torch ops:

- the input projection for every timestep is one matmul hoisted out of the
  recurrence; the recurrence is a Python loop over T that carries only
  ``h @ w_hh^T``;
- mixed precision as the reference's: each matmul takes the exact values
  in fp32, accumulates in fp32 and is cast back to the input's dtype
  (``_linear``); the gates and the cell update are computed in fp32; ``h``
  and ``c`` are rounded to the input's dtype after every step (so, unlike
  cuDNN's ``nn.LSTM``, ``c`` is not carried in fp32);
- a bidirectional layer runs the reversed loop too and concatenates the
  features; dropout applies between stacked layers only, drawn from a
  ``torch.Generator`` (the reference's semantics, not its ``jax.random``
  bits); ``batch_first`` swaps the first two axes; hidden states use the
  ``(layers * dirs, B, H)`` layout.

Usage::

    rnn = LSTM(input_size=32, hidden_size=64, num_layers=2, device="cpu")
    rnn.init(torch.Generator().manual_seed(0))
    out, (h, c) = rnn(x)            # x: (T, B, in); out: (T, B, H)
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch._device import resolve_device
from apex_tpu_torch.ops.dropout import dropout as _dropout

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "ApexRNN"]


def _linear(x: torch.Tensor, w: torch.Tensor,
            b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ w.T (+ b)`` of the exact values in fp32, cast back to
    ``x.dtype``."""
    y = torch.matmul(x.float(), w.float().t())
    if b is not None:
        y = y + b.float()
    return y.to(x.dtype)


# gate multiplier and number of hidden states per cell kind
# (RNNBackend.py:242 gate_multiplier / n_hidden_states)
_CELLS = {
    "lstm": (4, 2),
    "gru": (3, 1),
    "relu": (1, 1),
    "tanh": (1, 1),
    "mlstm": (4, 2),
}

# the order init draws a layer's leaves in
_LEAVES = ("w_ih", "w_hh", "b_ih", "b_hh", "w_mih", "w_mhh", "w_ho")


def _cell_step(kind: str, xg: torch.Tensor, h: torch.Tensor,
               c: Optional[torch.Tensor], p, xm: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One recurrence step. ``xg`` is this timestep's ``x @ Wih^T +
    b_ih``, ``xm`` its ``x @ Wmih^T`` (mLSTM). Returns (h', c')."""
    b_hh = p["b_hh"] if "b_hh" in p else None
    if kind in ("lstm", "mlstm"):
        hin = xm * _linear(h, p["w_mhh"]) if kind == "mlstm" else h
        gates = (xg + _linear(hin, p["w_hh"], b_hh)).float()
        i, f, g, o = gates.chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new.to(h.dtype), c_new.to(h.dtype)
    if kind == "gru":
        hg = _linear(h, p["w_hh"], b_hh).float()
        xgf = xg.float()
        hd = h.shape[-1]
        r = torch.sigmoid(xgf[..., :hd] + hg[..., :hd])
        z = torch.sigmoid(xgf[..., hd:2 * hd] + hg[..., hd:2 * hd])
        n = torch.tanh(xgf[..., 2 * hd:] + r * hg[..., 2 * hd:])
        h_new = (1.0 - z) * n + z * h.float()
        return h_new.to(h.dtype), None
    pre = (xg + _linear(h, p["w_hh"], b_hh)).float()
    act = torch.relu(pre) if kind == "relu" else torch.tanh(pre)
    return act.to(h.dtype), None


class ApexRNN(nn.Module):
    """Stacked, optionally bidirectional RNN over one cell kind, on
    ``device`` (default the card: pass ``device="cpu"`` for the plain CPU
    path)."""

    def __init__(self, kind: str, input_size: int, hidden_size: int,
                 num_layers: int = 1, bias: bool = True,
                 batch_first: bool = False, dropout: float = 0.0,
                 bidirectional: bool = False,
                 output_size: Optional[int] = None,
                 params_dtype: torch.dtype = torch.float32,
                 device="cuda"):
        super().__init__()
        if kind not in _CELLS:
            raise ValueError(f"unknown cell kind {kind!r}")
        self.kind = kind
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.bias = bias
        self.batch_first = batch_first
        self.dropout = dropout
        self.bidirectional = bidirectional
        self.output_size = output_size
        self.params_dtype = params_dtype
        self.gate_mult, self.n_states = _CELLS[kind]
        # RNNBackend.py:232 RNNCell(output_size): h is projected by w_ho
        # when output_size != hidden_size
        self.proj = output_size is not None and output_size != hidden_size
        if self.proj and kind == "gru":
            # the GRU mixes h into the candidate elementwise, so a
            # projected h of another width cannot type-check (the
            # reference has the same limit)
            raise ValueError("output_size projection is not defined for GRU")
        self.out_size = output_size if self.proj else hidden_size
        self.dirs = 2 if bidirectional else 1
        dev = resolve_device(device)
        for layer in range(num_layers):
            in_size = input_size if layer == 0 else self.out_size * self.dirs
            for d in range(self.dirs):
                self.add_module(self._name(layer, d),
                                self._layer_params(in_size, dev))

    @staticmethod
    def _name(layer: int, d: int) -> str:
        return f"l{layer}{'_rev' if d else ''}"

    def _layer_params(self, in_size: int, dev) -> nn.ParameterDict:
        h, g, o = self.hidden_size, self.gate_mult, self.out_size
        shapes = {"w_ih": (g * h, in_size), "w_hh": (g * h, o)}
        if self.bias:
            shapes["b_ih"] = (g * h,)
            shapes["b_hh"] = (g * h,)
        if self.kind == "mlstm":
            # cells.py mLSTMRNNCell sizes the multiplicative pair by
            # output_size so m matches w_hh's contraction
            shapes["w_mih"] = (o, in_size)
            shapes["w_mhh"] = (o, o)
        if self.proj:
            shapes["w_ho"] = (o, h)
        return nn.ParameterDict({
            k: nn.Parameter(torch.empty(shapes[k], dtype=self.params_dtype,
                                        device=dev))
            for k in _LEAVES if k in shapes})

    def layer(self, layer: int, d: int = 0) -> nn.ParameterDict:
        return getattr(self, self._name(layer, d))

    def init(self, generator: torch.Generator) -> "ApexRNN":
        """Every weight uniform in ``+-1/sqrt(hidden)`` (torch's RNN
        ``reset_parameters``), drawn on the host from the CPU ``generator``
        layer by layer, direction by direction, in the order of
        ``_LEAVES``; not the JAX package's draws."""
        bound = 1.0 / self.hidden_size ** 0.5
        for layer in range(self.num_layers):
            for d in range(self.dirs):
                for p in self.layer(layer, d).values():
                    vals = torch.rand(tuple(p.shape), generator=generator,
                                      dtype=torch.float32)
                    with torch.no_grad():
                        p.copy_(vals * (2 * bound) - bound)
        return self

    def init_hidden(self, batch: int, dtype=None, device=None) -> Any:
        """Zero hidden state in torch's ``(layers * dirs, B, H)`` layout
        (``RNNBackend.py:309``)."""
        dtype = dtype or self.params_dtype
        device = device or self.layer(0)["w_ih"].device
        n = self.num_layers * self.dirs
        h = torch.zeros((n, batch, self.out_size), dtype=dtype, device=device)
        if self.n_states == 2:
            c = torch.zeros((n, batch, self.hidden_size), dtype=dtype,
                            device=device)
            return (h, c)
        return h

    def _run_layer(self, p, x: torch.Tensor, h: torch.Tensor,
                   c: Optional[torch.Tensor], reverse: bool):
        """x: (T, B, in) -> (T, B, out). One hoisted matmul for the input
        projection of every timestep; the loop carries h (and c)."""
        xg = _linear(x, p["w_ih"], p["b_ih"] if "b_ih" in p else None)
        xm = _linear(x, p["w_mih"]) if self.kind == "mlstm" else None
        steps = range(x.shape[0] - 1, -1, -1) if reverse else range(x.shape[0])
        ys: List[Optional[torch.Tensor]] = [None] * x.shape[0]
        for t in steps:
            h, c = _cell_step(self.kind, xg[t], h, c, p,
                              None if xm is None else xm[t])
            if self.proj:
                h = _linear(h, p["w_ho"])
            ys[t] = h
        return torch.stack(ys), h, c

    def forward(self, x: torch.Tensor, hidden: Any = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, Any]:
        """Returns ``(output, h)`` or ``(output, (h, c))``; seq-major
        unless ``batch_first``. With a ``generator`` and ``dropout > 0``,
        train-mode dropout between stacked layers."""
        if self.batch_first:
            x = x.transpose(0, 1)
        if hidden is None:
            hidden = self.init_hidden(x.shape[1], x.dtype, x.device)
        h_all, c_all = hidden if self.n_states == 2 else (hidden, None)
        h_out, c_out = [], []
        for layer in range(self.num_layers):
            outs = []
            for d in range(self.dirs):
                idx = layer * self.dirs + d
                c0 = c_all[idx].to(x.dtype) if c_all is not None else None
                ys, h_f, c_f = self._run_layer(
                    self.layer(layer, d), x, h_all[idx].to(x.dtype), c0,
                    reverse=bool(d))
                outs.append(ys)
                h_out.append(h_f)
                if c_f is not None:
                    c_out.append(c_f)
            x = outs[0] if self.dirs == 1 else torch.cat(outs, dim=-1)
            if layer < self.num_layers - 1:
                x = _dropout(x, self.dropout, generator)
        out = x.transpose(0, 1) if self.batch_first else x
        h_stack = torch.stack(h_out)
        if self.n_states == 2:
            return out, (h_stack, torch.stack(c_out))
        return out, h_stack


def _factory(kind: str, doc: str):
    def make(input_size, hidden_size, num_layers, bias=True,
             batch_first=False, dropout=0.0, bidirectional=False,
             output_size=None, **kw) -> ApexRNN:
        return ApexRNN(kind, input_size, hidden_size, num_layers, bias,
                       batch_first, dropout, bidirectional, output_size,
                       **kw)
    make.__doc__ = doc
    return make


LSTM = _factory("lstm", "``reference:apex/RNN/models.py:19``.")
GRU = _factory("gru", "``reference:apex/RNN/models.py:26``.")
ReLU = _factory("relu", "``reference:apex/RNN/models.py:33``.")
Tanh = _factory("tanh", "``reference:apex/RNN/models.py:40``.")
mLSTM = _factory("mlstm", "``reference:apex/RNN/models.py:47`` / "
                 "``cells.py:55``: the multiplicative LSTM (Krause et al.).")
