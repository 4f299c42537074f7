"""The training config tree of the port.

Counterpart of ``apex_tpu/config.py``: one typed dataclass tree that
*builds* the pieces of a trainer (the amp policy, the loss scale, the
model, the optimizer, the mesh) and serializes to JSON
(``to_dict``/``from_dict``, tuples restored). The fields are the
reference's, so a config written by either package reads in the other.
``zero=1`` builds the ZeRO-1 optimizers over the bucket grid of
``ddp_bucket_bytes``; :meth:`TrainConfig.initialize_mesh` lays out the
process groups (:mod:`apex_tpu_torch.transformer.parallel_state`), and
:meth:`TrainConfig.fastpath` is the reference's preset.

A GPT model builds at tensor parallelism above 1, with sequence
parallelism and its comm overlap, on the tensor group of the installed
mesh (:meth:`TrainConfig.initialize_mesh` first), and at pipeline
parallelism above 1, where it holds every layer and
:class:`~apex_tpu_torch.training.GPTHybridTrainer` cuts out a rank's
stage. :meth:`TrainConfig.build_microbatch_calculator` and
:meth:`TrainConfig.build_sampler` build the reference's calculator and
Megatron samplers. At context parallelism above 1 only the mesh gains the
context axis, as in the reference: the model builds as at cp 1, and its
caller attends over the context group with
:mod:`apex_tpu_torch.transformer.context_parallel`.
:meth:`TrainConfig.build_health` builds the numerics watchdog's
:class:`~apex_tpu_torch.observability.health.HealthConfig`. What needs an
unported piece raises ``NotImplementedError`` naming its queue item:
``ddp_bucket_bytes="auto"``, which pyprof's roofline tuner resolves
(A7b). Unknown names raise the reference's ``ValueError``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

__all__ = ["ModelConfig", "ParallelConfig", "BatchConfig", "OptimizerConfig",
           "TrainConfig"]

# optimizers with a ZeRO variant in the reference
ZERO_CAPABLE_OPTIMIZERS = ("adam", "adamw", "lamb")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (queue item "
                               f"{item})")


def _zero_enabled(v) -> bool:
    """Normalize ``OptimizerConfig.zero``: the legacy bool or the stage
    spelling ``"off" | 1 | "1"``; stage 1 is the only one the reference
    implements."""
    if v in (False, 0, None) or v == "off":
        return False
    if v in (True, 1) or v == "1":
        return True
    raise ValueError(
        f"unsupported zero={v!r}; expected off|1 (bools accepted)")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Network sizes (Megatron's ``_add_network_size_args``)."""
    name: str = "gpt"                 # "gpt" | "bert" | "resnet50"
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 1024
    ffn_hidden_size: Optional[int] = None
    hidden_dropout: float = 0.0
    attention_dropout: float = 0.0
    num_classes: int = 1000           # resnet head
    # activation remat (gpt/bert): remat_policy None | "none" | "full" |
    # "selective" | "offload"; remat is the deprecated bool ("full")
    remat: bool = False
    remat_policy: Optional[str] = None
    remat_names: Optional[Tuple[str, ...]] = None
    # Megatron sequence parallelism and its ring-overlapped GEMMs: tp > 1
    sequence_parallel: bool = False
    tp_comm_overlap: bool = False


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """Mesh axes; data parallelism is the size the world leaves."""
    tensor_model_parallel_size: int = 1
    pipeline_model_parallel_size: int = 1
    virtual_pipeline_model_parallel_size: Optional[int] = None
    context_parallel_size: int = 1
    dcn_data_parallel: Optional[bool] = None


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Batch sizing."""
    global_batch_size: int = 64
    micro_batch_size: int = 8
    rampup_batch_size: Optional[Tuple[int, int, int]] = None


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Optimizer selection."""
    name: str = "adam"                # adam|adamw|sgd|lamb|novograd|adagrad
    lr: float = 1e-4
    weight_decay: float = 0.01
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    momentum: float = 0.9             # sgd
    flat: bool = False                # wrap in FlatOptimizer
    # ZeRO stage over the data axis: off | 1 (bools accepted) builds
    # DistributedFusedAdam/LAMB, per bucket when ddp_bucket_bytes is set
    zero: Any = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: ModelConfig = ModelConfig()
    parallel: ParallelConfig = ParallelConfig()
    batch: BatchConfig = BatchConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    opt_level: str = "O2"             # amp policy preset
    half_dtype: str = "bfloat16"
    seed: int = 1234
    # the numerics watchdog (build_health): off | cheap | full, raise |
    # dump | skip, reports in a row before it fires, where dumps go
    health_level: str = "off"
    health_on_nonfinite: str = "skip"
    health_consecutive: int = 1
    health_dump_dir: str = "."
    # bytes a flat fp32 bucket of the DDP allreduce and the ZeRO
    # reduce-scatter/all-gather; None: one bucket. "auto" is resolved by
    # pyprof's roofline tuner in the reference (A7b), and raises here
    ddp_bucket_bytes: Any = None

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        d = dict(d)
        for field, sub in (("model", ModelConfig),
                           ("parallel", ParallelConfig),
                           ("batch", BatchConfig),
                           ("optimizer", OptimizerConfig)):
            if field in d and isinstance(d[field], dict):
                sub_d = dict(d[field])
                if field == "optimizer" and "betas" in sub_d:
                    sub_d["betas"] = tuple(sub_d["betas"])
                if field == "batch" and sub_d.get("rampup_batch_size"):
                    sub_d["rampup_batch_size"] = tuple(
                        sub_d["rampup_batch_size"])
                if field == "model" and sub_d.get("remat_names"):
                    sub_d["remat_names"] = tuple(sub_d["remat_names"])
                d[field] = sub(**sub_d)
        return cls(**d)

    # -- presets ------------------------------------------------------------
    _KEEP = object()   # fastpath(): no explicit bucket grid

    def fastpath(self, *, bucket_bytes: Any = _KEEP) -> "TrainConfig":
        """The reference's overlap preset, as a new config: ``zero=1``
        (raises for an optimizer with no ZeRO variant), the bucket grid
        (one set on the receiver is kept; an unset one becomes ``"auto"``,
        which :meth:`build_optimizer` refuses until the tuner is ported,
        A7b; ``bucket_bytes=`` pins it), ``remat_policy="selective"``
        unless a policy (or the deprecated ``remat=True``, "full") is
        set, and sequence parallelism with its comm overlap where the
        mesh carries them (tp > 1, pp == 1)."""
        if not _zero_enabled(self.optimizer.zero) \
                and self.optimizer.name not in ZERO_CAPABLE_OPTIMIZERS:
            raise ValueError(
                f"fastpath needs a ZeRO-capable optimizer "
                f"({'|'.join(ZERO_CAPABLE_OPTIMIZERS)}), got "
                f"{self.optimizer.name!r}")
        tp = self.parallel.tensor_model_parallel_size
        pp = self.parallel.pipeline_model_parallel_size
        sp_ok = tp > 1 and pp == 1
        policy = self.model.remat_policy or (
            "full" if self.model.remat else "selective")
        model = dataclasses.replace(
            self.model,
            remat_policy=policy,
            sequence_parallel=self.model.sequence_parallel or sp_ok,
            tp_comm_overlap=self.model.tp_comm_overlap or sp_ok)
        optimizer = (self.optimizer if _zero_enabled(self.optimizer.zero)
                     else dataclasses.replace(self.optimizer, zero=1))
        if bucket_bytes is TrainConfig._KEEP:
            bucket_bytes = (self.ddp_bucket_bytes
                            if self.ddp_bucket_bytes is not None
                            else "auto")
        return dataclasses.replace(self, model=model, optimizer=optimizer,
                                   ddp_bucket_bytes=bucket_bytes)

    # -- builders -----------------------------------------------------------
    def build_policy(self):
        from apex_tpu_torch.amp import get_policy
        half = (torch.bfloat16 if self.half_dtype == "bfloat16"
                else torch.float16)
        return get_policy(self.opt_level, half_dtype=half)

    def build_scaler(self):
        """The loss-scale object the policy implies (may be a no-op)."""
        from apex_tpu_torch.amp import make_loss_scale
        return make_loss_scale(self.build_policy().loss_scale)

    def build_model(self, device="cuda"):
        """The model on ``device`` (default the card), parameters
        allocated and not initialized: call its ``init(generator)`` or load
        a state dict. A GPT at tensor parallelism above 1 holds this
        rank's shards of the installed mesh's tensor group; at pipeline
        parallelism above 1 it holds every layer (a rank's stage is cut
        out by ``GPTModel.stage_fn``)."""
        pol = self.build_policy()
        m = self.model
        if m.name == "gpt":
            from apex_tpu_torch.models import GPTConfig, GPTModel
            return GPTModel(GPTConfig(
                vocab_size=m.vocab_size, hidden_size=m.hidden_size,
                num_layers=m.num_layers,
                num_attention_heads=m.num_attention_heads,
                max_position_embeddings=m.max_position_embeddings,
                ffn_hidden_size=m.ffn_hidden_size,
                tensor_model_parallel_size=
                self.parallel.tensor_model_parallel_size,
                params_dtype=pol.param_dtype,
                compute_dtype=pol.compute_dtype,
                hidden_dropout=m.hidden_dropout,
                attention_dropout=m.attention_dropout, remat=m.remat,
                remat_policy=m.remat_policy, remat_names=m.remat_names,
                sequence_parallel=m.sequence_parallel,
                tp_comm_overlap=m.tp_comm_overlap),
                device=device)
        if m.name == "bert":
            from apex_tpu_torch.models import BertConfig, BertModel
            return BertModel(BertConfig(
                vocab_size=m.vocab_size, hidden_size=m.hidden_size,
                num_layers=m.num_layers,
                num_attention_heads=m.num_attention_heads,
                max_position_embeddings=m.max_position_embeddings,
                remat=m.remat, remat_policy=m.remat_policy,
                remat_names=m.remat_names,
                compute_dtype=pol.compute_dtype), device=device)
        if m.name == "resnet50":
            from apex_tpu_torch.models import ResNet50, ResNetConfig
            return ResNet50(ResNetConfig(
                num_classes=m.num_classes, compute_dtype=pol.compute_dtype,
                params_dtype=pol.param_dtype), device=device)
        raise ValueError(f"unknown model {m.name!r}")

    def build_optimizer(self):
        from apex_tpu_torch import optimizers as opt

        o = self.optimizer
        if _zero_enabled(o.zero):
            if o.name not in ZERO_CAPABLE_OPTIMIZERS:
                raise ValueError(
                    f"no ZeRO variant of {o.name!r} (capable: "
                    f"{'|'.join(ZERO_CAPABLE_OPTIMIZERS)})")
            if self.ddp_bucket_bytes == "auto":
                raise _unported(
                    'ddp_bucket_bytes="auto" (the reference resolves it '
                    "with pyprof's tune_bucket_bytes; pass an int)", "A7b")
            if o.name in ("adam", "adamw"):
                return opt.DistributedFusedAdam(
                    lr=o.lr, betas=o.betas, eps=o.eps,
                    adam_w_mode=o.name == "adamw",
                    weight_decay=o.weight_decay,
                    bucket_bytes=self.ddp_bucket_bytes)
            return opt.DistributedFusedLAMB(
                lr=o.lr, betas=o.betas, eps=o.eps,
                weight_decay=o.weight_decay,
                bucket_bytes=self.ddp_bucket_bytes)
        if o.name in ("adam", "adamw"):
            inner = opt.FusedAdam(lr=o.lr, betas=o.betas, eps=o.eps,
                                  adam_w_mode=o.name == "adamw",
                                  weight_decay=o.weight_decay)
        elif o.name == "sgd":
            inner = opt.FusedSGD(lr=o.lr, momentum=o.momentum,
                                 weight_decay=o.weight_decay)
        elif o.name == "lamb":
            inner = opt.FusedLAMB(lr=o.lr, betas=o.betas, eps=o.eps,
                                  weight_decay=o.weight_decay)
        elif o.name == "novograd":
            inner = opt.FusedNovoGrad(lr=o.lr, betas=o.betas, eps=o.eps,
                                      weight_decay=o.weight_decay)
        elif o.name == "adagrad":
            inner = opt.FusedAdagrad(lr=o.lr, weight_decay=o.weight_decay)
        else:
            raise ValueError(f"unknown optimizer {o.name!r}")
        return opt.FlatOptimizer(inner) if o.flat else inner

    def build_health(self):
        """The numerics-watchdog policy (level "off" by default, which
        adds nothing to a step)."""
        from apex_tpu_torch.observability.health import HealthConfig
        return HealthConfig(level=self.health_level,
                            on_nonfinite=self.health_on_nonfinite,
                            consecutive=self.health_consecutive,
                            dump_dir=self.health_dump_dir)

    def build_microbatch_calculator(self, data_parallel_size: int):
        """The microbatch calculator of this batch config (constant, or
        ramped by ``rampup_batch_size``)."""
        from apex_tpu_torch.transformer.pipeline_parallel.microbatches \
            import build_num_microbatches_calculator
        ram = (list(self.batch.rampup_batch_size)
               if self.batch.rampup_batch_size else None)
        return build_num_microbatches_calculator(
            rank=0, rampup_batch_size=ram,
            global_batch_size=self.batch.global_batch_size,
            micro_batch_size=self.batch.micro_batch_size,
            data_parallel_size=data_parallel_size)

    def build_sampler(self, total_samples: int, consumed_samples: int,
                      data_parallel_rank: int, data_parallel_size: int,
                      shuffle: bool = False):
        """A Megatron pretraining sampler whose local minibatch is
        ``global_batch_size / data_parallel_size``, shuffled with
        ``shuffle``."""
        from apex_tpu_torch.transformer._data import (
            MegatronPretrainingRandomSampler, MegatronPretrainingSampler)
        local = self.batch.global_batch_size // data_parallel_size
        cls = (MegatronPretrainingRandomSampler if shuffle
               else MegatronPretrainingSampler)
        return cls(total_samples=total_samples,
                   consumed_samples=consumed_samples,
                   local_minibatch_size=local,
                   data_parallel_rank=data_parallel_rank,
                   data_parallel_size=data_parallel_size)

    def initialize_mesh(self, devices=None):
        """:func:`~apex_tpu_torch.transformer.parallel_state.
        initialize_model_parallel` with this config's sizes, after
        ``torch.distributed.init_process_group``; returns the mesh."""
        from apex_tpu_torch.transformer import parallel_state
        return parallel_state.initialize_model_parallel(
            tensor_model_parallel_size=
            self.parallel.tensor_model_parallel_size,
            pipeline_model_parallel_size=
            self.parallel.pipeline_model_parallel_size,
            virtual_pipeline_model_parallel_size=
            self.parallel.virtual_pipeline_model_parallel_size,
            context_parallel_size=self.parallel.context_parallel_size,
            devices=devices,
            dcn_data_parallel=self.parallel.dcn_data_parallel)
