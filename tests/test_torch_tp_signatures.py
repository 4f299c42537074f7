"""C-3: the port's sharded linears take the reference's arguments in the
reference's order (``apex_tpu/transformer/tensor_parallel/layers.py``):
``ColumnParallelLinear`` with ``no_async_tensor_model_parallel_allreduce``
and ``gradient_accumulation_fusion`` (accepted no-ops) before
``sequence_parallel``, and ``RowParallelLinear``; built from the same
positional arguments and from the same keywords, both packages' layers
hold the same settings and weight shapes. And
``DistributedDataParallel.value_and_grad``: ``argnums=0`` and ``has_aux``
taken, a ``jax.value_and_grad`` keyword with no torch meaning refused by
name."""

import inspect

import jax
import jax.numpy as jnp
import pytest
import torch

from apex_tpu.transformer.tensor_parallel import layers as J
from apex_tpu_torch.parallel import DistributedDataParallel
from apex_tpu_torch.transformer.tensor_parallel import layers as T

IN, OUT = 8, 12
ATTRS = ("input_size", "output_size", "sequence_parallel", "seq_axis",
         "tp_comm_overlap", "skip_bias_add", "world_size")


def _positional(cls_name, jdtype, tdtype, flags):
    """The reference's positional arguments up to ``sequence_parallel``
    (eleven for Column), then ``seq_axis`` and ``tp_comm_overlap``."""
    sp, overlap, skip, gather, na, gaf = flags
    if cls_name == "ColumnParallelLinear":
        head = [IN, OUT, True, gather, None, skip]
        tail = [1, na, gaf, sp, 0, overlap]
    else:
        head = [IN, OUT, True, gather, None, skip]
        tail = [1, sp, 0, overlap]
    return head + [jdtype] + tail, head + [tdtype] + tail


FLAGS = [(False, False, False, True, False, False),
         (True, False, True, False, True, False),
         (True, True, False, True, False, True),
         (True, True, True, False, True, True)]


def _check(ref, port, cls_name):
    for name in ATTRS:
        assert getattr(port, name) == getattr(ref, name), name
    params = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    assert tuple(port.weight.shape) == tuple(params["weight"].shape[1:])
    assert port.bias.shape[0] == (params["bias"].shape[-1])
    if cls_name == "ColumnParallelLinear":
        assert port.gather_output == ref.gather_output
        assert port.output_size_per_partition == \
            ref.output_size_per_partition
    else:
        assert port.input_is_parallel == ref.input_is_parallel
        assert port.input_size_per_partition == ref.input_size_per_partition


@pytest.mark.parametrize("cls_name", ["ColumnParallelLinear",
                                      "RowParallelLinear"])
@pytest.mark.parametrize("flags", FLAGS)
def test_same_positional_arguments(cls_name, flags):
    jargs, targs = _positional(cls_name, jnp.float32, torch.float32, flags)
    ref = getattr(J, cls_name)(*jargs)
    port = getattr(T, cls_name)(*targs, device="cpu")
    _check(ref, port, cls_name)
    if cls_name == "ColumnParallelLinear":
        assert len(jargs) == 13  # eleven up to sequence_parallel, then two


@pytest.mark.parametrize("cls_name", ["ColumnParallelLinear",
                                      "RowParallelLinear"])
@pytest.mark.parametrize("flags", FLAGS)
def test_same_keywords(cls_name, flags):
    sp, overlap, skip, gather, na, gaf = flags
    kw = dict(bias=True, skip_bias_add=skip, world_size=1,
              sequence_parallel=sp, seq_axis=0, tp_comm_overlap=overlap)
    if cls_name == "ColumnParallelLinear":
        kw.update(gather_output=gather,
                  no_async_tensor_model_parallel_allreduce=na,
                  gradient_accumulation_fusion=gaf)
    else:
        kw.update(input_is_parallel=gather)
    ref = getattr(J, cls_name)(IN, OUT, **kw)
    port = getattr(T, cls_name)(IN, OUT, device="cpu", **kw)
    _check(ref, port, cls_name)


@pytest.mark.parametrize("cls_name", ["ColumnParallelLinear",
                                      "RowParallelLinear"])
def test_parameter_order_is_the_references(cls_name):
    """The port's parameters are the reference's, in order, then
    ``device``."""
    ref = list(inspect.signature(getattr(J, cls_name)).parameters)
    port = list(inspect.signature(getattr(T, cls_name)).parameters)
    assert port == ref + ["device"]


def test_overlap_without_sequence_parallel_is_refused_alike():
    for mod, kw in ((J, {}), (T, {"device": "cpu"})):
        with pytest.raises(ValueError, match="tp_comm_overlap"):
            mod.ColumnParallelLinear(IN, OUT, world_size=1,
                                     gradient_accumulation_fusion=True,
                                     tp_comm_overlap=True, **kw)


def test_no_op_flags_change_nothing():
    """The two accepted flags leave the layer's output as it was."""
    x = torch.randn(3, IN, generator=torch.Generator().manual_seed(1))
    outs = []
    for na, gaf in ((False, False), (True, True)):
        layer = T.ColumnParallelLinear(
            IN, OUT, world_size=1, device="cpu",
            no_async_tensor_model_parallel_allreduce=na,
            gradient_accumulation_fusion=gaf)
        layer.init(torch.Generator().manual_seed(0))
        outs.append(layer(x)[0])
    assert torch.equal(outs[0], outs[1])


def _loss(params, x):
    return (params["w"] * x).sum() ** 2, {"x": x.sum()}


def test_value_and_grad_takes_argnums_zero_and_has_aux():
    ddp = DistributedDataParallel(delay_allreduce=True)
    params = {"w": torch.ones(3, requires_grad=True)}
    x = torch.arange(3.0)
    (value, aux), grads = ddp.value_and_grad(_loss, argnums=0,
                                             has_aux=True)(params, x)
    assert float(value) == 9.0 and float(aux["x"]) == 3.0
    assert torch.equal(grads["w"], 2 * 3.0 * x)
    value2, grads2 = ddp.value_and_grad(
        lambda p, x: _loss(p, x)[0])(params, x)
    assert float(value2) == 9.0 and torch.equal(grads2["w"], grads["w"])


@pytest.mark.parametrize("kw,name", [
    (dict(holomorphic=True), "holomorphic"),
    (dict(allow_int=True), "allow_int"),
    (dict(reduce_axes=("batch",)), "reduce_axes"),
    (dict(argnums=1), "argnums"),
    (dict(argnums=(0, 1)), "argnums"),
])
def test_value_and_grad_refuses_keywords_with_no_torch_meaning(kw, name):
    ddp = DistributedDataParallel(delay_allreduce=True)
    with pytest.raises(TypeError, match=name):
        ddp.value_and_grad(_loss, **kw)
