#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py [group ...]``. It
needs one CUDA card and ``nvcc`` (the kernels are built from
``apex_tpu_torch/csrc`` on first use); without a card, or without the
package beside it, it exits non-zero and prints no result. With no
argument it runs every group of phases; named groups run alone, after
the build and the kernel checks (1-3 below), which run in every call:
``serving`` (4-7), ``serving_host`` (8-10), ``training`` (11-17),
``models`` (18-22), ``dist`` (23-31), ``elastic`` (32-33) and
``observability`` (34-37); an unknown name exits non-zero. A call without ``training`` takes B6's row of the
kernels line from ``long_context``'s kernel checks and timings alone.
Every call ends with the phases' wall seconds, the card's line, the
kernels line (launches summed over the groups that ran) and the result
line. Phases, each fatal on failure:

1. the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels, timed (and each source's nvcc), and print the
   registers, spills and shared memory of the tensor-core bodies
   (``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` with and without the
   folded dbias), the registers and spills of ``ln_bwd``'s row kernel and
   of the decode kernels' template instances from ptxas's report;
3. each kernel against its plain PyTorch version on the card, element by
   element and by relative norm, with the max abs error and the share of
   the limit used (the limits are stated and derived below the imports;
   the LayerNorm kernels and the flash kernels with a score bias follow
   the list below):
   ``flash_fwd`` at the serving prefill
   shape; ``flash_fwd`` with dropout, ``flash_bwd_dq`` and
   ``flash_bwd_dkv`` at the training shape (96 x 1024 x 1024, d 64,
   causal, bf16) and at ragged, cross, non-causal, fp32 d 128, fully masked
   and dropout 0.1 cases, and the dropout mask read back from the kernel
   bit for bit (the three flash kernels run their tensor-core bodies on
   bf16 inputs and their SIMT bodies on fp32 ones); a second launch of each
   at the training shape equal to the first bit for bit, and how many
   scores ``flash_bwd_dq``'s rounding pass took again there (and at BERT's
   and the long-context shapes); ``decode_attention`` at the serving path's
   shapes, at int8 and multi-row cases, at one slot with every cursor in
   {0, 1, 63, 64, 65, 1023, 1024}, int8 at q_len 4 and bf16 d 128, each
   launch repeated bit for bit, timed at 8 slots and at one slot at the
   full prefix and at the serving step's cursors, with a sha256 of its
   outputs' bits over these cases; ``paged_decode_attention``
   at the paged serving path's shape (tables a random permutation of the
   pool), with an int8 pool, 5 q rows, fp32 d 128 with 16-token blocks,
   48-token blocks (also with chunk edges inside blocks), 1-token blocks,
   each launch repeated bit for bit, and a poison case (every block no
   cursor covers filled with NaN, every table entry past the cursors
   pointing nowhere: the output must not change by a bit), timed at 8
   slots and at one slot at the full prefix and at the serving step's
   cursors beside ``decode_attention`` at the same cursors; both decode
   kernels at every head dim they take (d 8 to 256 in steps of 8, bf16 q
   over a bf16 cache at q_len 1 and 3, over int8 at one d of each
   lane-group width, fp32 past d 128, an empty slot in each), and d 4, 12
   and 264 refused; the four flash kernels (``check_flash_head_dims``) at
   every head dim from 8 to 256 in steps of 8, each at its body width
   ``_kernels.flash_width(d)`` (4 batch-heads x 96 x 96, causal, bf16 and
   fp32, bf16 with a ``(2, 2, 1, 96)`` bias, dropout 0.1 and the folded
   dbias, fp32 with a ``(1, 2, 96, 96)`` table and ``flash_dbias``), each
   launch repeated bit for bit, d 4, 12 and 264 refused, and
   (``flash_dim_timings``) B1-B3 at 96 x 1024 x 1024, causal, bf16, at d
   16, 64, 80, 96, 128 and 256 beside each d's bound: no d may be slower
   than a larger one. Kernel, plain and library (SDPA
   forward, and SDPA backward for the dQ/dK/dV pair: yardsticks only, the
   port never calls SDPA; no PyTorch call reads a block table, so the paged
   kernel is timed beside the dense decode kernel instead) device times
   under ``torch.profiler``, beside the bound. ``ln_fwd`` and ``ln_bwd`` at the
   path shape (8192 x 768: bf16 with bf16 affine parameters, fp32, mixed,
   RMSNorm, no affine), at 1024 x 16384 and at 1001 rows of the widths
   just past each kernel template's reach (264, 1032, 4104) and of 8, in
   bf16 and fp32, dweight/dbias within a stated fp32 relative norm and a
   second ``ln_bwd`` equal bit for bit, timed
   beside ``F.layer_norm``, ``aten.native_layer_norm_backward`` and
   ``F.rms_norm``, with ``ln_bwd``'s grid; the three flash kernels with a
   ``(16, 1, 1, 512)``
   padding bias and a ``(1, 12, 512, 512)`` bias at BERT's attention shape
   (192 x 512 x 512, d 64, non-causal, bf16) and at causal, dropout and
   fp32 cases, timed at BERT's shape beside SDPA with a float mask; the
   flash kernels with segment ids (self-attention ids, a pair at sq < sk
   with a query id no key carries, ids with a padding bias, causal and
   dropout 0.1; d 32, 64, 128, bf16 and fp32) and
   ``examples/long_context.py``'s packed call; ``flash_bwd_dq``'s bf16 body
   at d 32, 64 and 128: causal, cross, ragged, fully masked rows (dq 0), a
   padding bias, a per-head bias, segment ids and dropout 0.1, each launch
   repeated bit for bit; ``flash_dbias`` at six
   bias shapes of ``(2, 12, 512, 512)``, with and without causal, dropout
   0.3 and ids (fp32 and bf16), and ragged, each launch repeated bit for
   bit, and at the two row shapes in bf16 the dbias folded into
   ``flash_bwd_dkv`` (repeated bit for bit, its dK/dV equal to the
   unfolded launch's);
4. GPT-small (vocab 32768, hidden 768, 12 layers, 12 heads, 1024
   positions; random weights from a seed) served at full width: a
   ``ServingEngine`` (8 slots, max_len 1024, prefill window 128, bf16
   cache) under a ``SlotScheduler`` with 16 requests of mixed prompt
   lengths, 32 new tokens each, half greedy. Launch counts are set to 0
   just before the run and read just after: ``flash_fwd`` must run 12
   times per prefill and ``decode_attention`` 12 times per decode step.
   Then prefill and decode-step times, and a teacher-forced check of the
   kernel path's logits against the plain path's on the card;
5. the same model served by a ``PagedServingEngine`` (the JAX bench's
   ``gpt_decode_paged`` configuration: 8 slots, max_len 1024, prefill
   window 128, 128-token blocks, 65 pool blocks, bf16 pool) under a
   ``SlotScheduler``: the 16 requests above plus 4 greedy ones that repeat
   one 128-token prompt, so three admissions share its block and copy it
   on write. ``paged_decode_attention`` must run 12 times per decode step
   (prefix-hit tail steps included), ``flash_fwd`` 12 times per cold
   prefill, ``decode_attention`` never; at least 3 prefix hits and 3
   copies; every block back in the pool after the run. Then cold and
   prefix-hit prefill times, decode-step times and device-busy profiles
   beside the dense engine's, and teacher-forced logits of the paged kernel
   path against the paged plain path and the dense engine;
6. speculative serving at ``bench.py::bench_gpt_decode_spec``'s workload
   (``BENCH_DECODE_CONFIGS["gpt_decode_spec"]``: the same model, 4 slots,
   max_len 1024, prefill window 128, bf16 cache, ``speculate_k`` 4; 8
   requests whose prompts are 128-token windows of one 8-token pattern
   repeated, 48 greedy tokens each, ``NGramDraftSource``): a plain leg and
   a speculative leg through ``SlotScheduler.run``, each after a warm run,
   with both legs' tokens/s, their ratio, the accept rate and the step
   counts; every request 48 tokens and ``"length"``; ``decode_attention``
   12 launches a step (a verify step is one launch a layer at q_len 5),
   ``paged_decode_attention`` none, ``ln_fwd`` 25 a pass,
   ``serve/spec_steps == serve/decode_steps``. Then, against the plain
   engine's greedy streams: (a) teacher-forced drafts (the stream itself),
   every window accepted whole and each verify row's logits within
   ``TOL_LOGITS`` of the plain logits at its position; (b) drafts
   ``(argmax + 1) % vocab``, every count 1 and the emitted token the plain
   one; (c) the legs' completions equal to the plain stream up to its
   first near-tie (a top-1/top-2 logit gap within twice (a)'s error; a
   window may stop short and an emitted token differ only there), then
   both legs teacher-forced over every token (the plain leg fed the
   reference's tokens, the speculative leg verifying n-gram drafts of the
   reference's context), each re-synchronised on the reference after a
   near-tie where it differed: the tokens checked out of the total and
   those near-ties printed. The
   verify step's host-clock time and launches beside the plain decode
   step's, and a profile of it. (a)-(c) again with an fp32 cache and fp32
   compute;
7. the same with a ``PagedServingEngine`` (128-token blocks, 33 pool
   blocks, bf16 pool) and two more requests that repeat the first prompt
   (prefix hits with copy on write; in (a) the repeats are admitted by the
   allocator alone, so their first verify window copies the shared
   block): ``paged_decode_attention`` 12 launches a step, prefix-hit tail
   steps included, ``decode_attention`` none. Then both decode kernels at
   the verify step's shape (4 slots x 12 heads x 5 rows, d 64, bf16 q) at
   the run's cursors, at cursors {0, 1, 127, 128} and {1019, 1020, 255,
   256}, over bf16 and int8 caches (the paged pool's tables shuffled):
   each launch against its plain version, out and lse, repeated bit for
   bit, and the op with the in-flight rows merged (``k_new``, ``k_cast``)
   against its plain version; device times of both at q_len 5, 4 and 1 at
   the verify step's cursors beside the bound, and B4 at q_len 5 beside
   SDPA with a boolean mask (a yardstick only);
8. ``serve_goodput``: ``bench.py::bench_gpt_decode``'s ``serve_leg`` on
   the port at 1 and 8 slots (the same GPT-small, bf16 cache): 2 x slots
   requests of 8 tokens under ``DECODE_SLO`` (TTFT p95 <= 2000 ms, TPOT
   p99 <= 500 ms) with a ``RequestTrace`` and an ``SLOTracker``, then a
   burst of 4 x slots requests at ``max_queue = slots``: TTFT and TPOT
   p50/p95/p99, goodput, rejected, expired and the overload goodput; the
   rejected count equal to the submits that returned a ``Rejection``,
   every admitted request completed, the queue never past its bound;
9. ``serve_chaos``: ``FaultPlan.sample_serving`` (flood 4, slow step
   0.002 s, ``total_steps`` from a fault-free run) on quarantine engines,
   dense at 8 slots, paged and dense speculative (``speculate_k`` 4) at 4
   slots: exactly the poisoned slot retires ``"poisoned"``, its
   ``poison_dump_*.json`` is strict JSON, every other request's tokens
   equal the flood-only run's; then on the dense engine cancel (queued
   and mid-flight), a queued and a mid-flight expiry, ``drain`` and
   ``swap_params`` to seed 1's weights (the greedy stream changes), and
   an injected decode fault (every in-flight request ``"error"``, then a
   new request served);
10. ``host_cost_off``: steady dense decode steps, paged decode steps and
   verify steps under ``torch.profiler``, four one-step windows each read
   by the largest count (a window now and then loses its first events): a
   scheduler with every host
   knob attached (trace, SLO tracker, queue bound, default deadline,
   brownout, an empty fault plan) launches the kernels and makes the
   device-to-host copies of a bare one; a quarantine engine adds at most
   its finite check's few launches and no copy;
11. GPT-small trained at full width, the twin of
   ``bench.py::_gpt_train_step`` (batch 8 x 1024 tokens, bf16 compute,
   ``FusedAdam(lr=1e-4)``, ``DynamicLossScale(init_scale=2**12)``): launch
   counts reset around each step, which must launch ``flash_fwd``,
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` 12 times each; step time,
   tokens/s, each step's loss, a profile of one step; then the plain path
   from the same state dict, whose losses and step-0 grads must agree;
   then one step of each path with train-mode dropout (hidden and
   attention, 0.1, a generator on the card), which must agree too. Every
   GPT pass (prefill, decode step, training forward) must launch
   ``ln_fwd`` 25 times, and every training backward ``ln_bwd`` 25 times.
   Beside it, ``serve_small`` (after the dense serving phase) serves
   ``examples/gpt_serve.py``'s default model (head dim 16) with its demo
   requests, teacher-forced logits against the plain path; ``train_small``
   trains ``examples/gpt_pretrain.py``'s model at one device (head dim 8)
   for 5 steps, the losses against the plain path's; and ``train_remat``
   runs ``bench.py::bench_gpt_remat``'s legs (``none``, ``selective``,
   ``full``, ``offload``) on this step: step ms, tokens/s, peak memory,
   launches, GEMMs and host copies a step, losses and step-0 grads equal
   to ``none``'s bit for bit, peak memory ``none > selective > full``,
   ``flash_fwd`` 12 a step (24 under ``full``), no GEMM run again under
   ``selective`` or ``offload``, and a dropout step under ``full`` and
   ``selective`` equal to ``none``'s;
12. ``train_config``: the same GPT-small built through ``TrainConfig``
   (``opt_level="O2"``, adam at lr 1e-4 with no weight decay: the built
   model's config and the optimizer's hyperparameters must equal
   ``train``'s), the explicit ``DynamicLossScale(2**12)``, 3 steps of
   ``scaled_value_and_grad`` and ``OptimizerBase.step`` under
   ``ingraph.reap``, each launching the three flash kernels 12 times and
   both LayerNorm kernels 25 times: losses and step 0's grads against
   ``train``'s hand-assembled step within ``TOL_TRAIN_*``,
   ``amp/loss_scale`` the new state's scale, ``amp/overflow_count`` 0,
   ``optim/grad_norm`` within 1e-6 of ``torch.linalg.vector_norm`` over
   the unscaled grads; with no collector open, one step's launches and
   host copies (four profiler windows, the largest reading) those of the
   hand-assembled step;
13. ``train_resnet``: ``bench.py::bench_headline``'s step at its full
   shape (ResNet-50, 1000 classes, 256 x 224 x 224 x 3 bf16 images from
   ``RandomState(0)``, bf16 compute with fp32 params, ``FlatOptimizer(
   FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))``,
   ``DynamicLossScale(2**12)`` with the unscale fused into
   ``opt.step(scale=1 / loss_scale)``): 5 warm-up and 20 timed steps,
   step ms and images/s (host clock around each synchronized step), peak
   memory, the share of the bf16 dense peak for the reference's analytic
   ``3 * 2 * 4.1e9 * 256`` FLOPs, a profile of one step (busy share,
   launches, the top device ops); finite losses, the scale state as
   ``DynamicLossScale`` moves it over the run's finite flags, no launch of
   the port's kernels (convs and BN are cuDNN and torch ops, XLA's in the
   reference); an fp32 (O0) leg of 2 steps from the same weights (step
   0's loss, grads and head-bias grad within ``TOL_O0_*``); and the small
   configuration (stages (1, 1, 1, 1), width 8, 8 x 32 x 32, fp32, 3
   steps) on the card against the CPU from one state dict;
14. BERT-base pretraining at full width (google-research/bert's
   ``uncased_L-12_H-768_A-12``: vocab 30522, hidden 768, 12 layers, 12
   heads, ffn 3072, 512 positions, 2 token types, eps 1e-12; random
   weights from a seed): 16 sequences of 512 positions with lengths drawn
   in 256-512 and the padding mask as the attention bias, token types, a
   0.15 MLM loss mask and sentence-order labels, ``BertModel.loss`` with
   every head, ``FusedAdam(lr=1e-4)``, ``DynamicLossScale(init_scale=
   2**12)``, no dropout: 4 steps, each launching ``flash_fwd``,
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` 12 times and ``ln_fwd`` and
   ``ln_bwd`` 26 times; step time, tokens/s, peak memory, a profile; then
   3 steps of the plain path, which must launch nothing and agree on the
   losses and step 0's grads;
15. long-context attention at ``bench.py::bench_flash_long``'s shape (8 x 12
   heads, 4096 positions, d 64, bf16, causal; q, k, v and dy from
   ``RandomState(0)``) with four packed documents a row (segment ids, the
   cut points drawn from the same stream) and a learned ALiBi row bias
   ``slope_h * j`` whose slopes start at ALiBi's ``2**(-8 (i + 1) / 12)``:
   the four flash kernels against their plain versions batch by batch (a
   second launch of each equal bit for bit; the folded dbias too, and it
   again on ``RandomState(1)``-``(3)``'s inputs, under slopes 2 and 4
   times steeper and, after the steps below, with the slopes they
   trained), and
   ``flash_dbias`` at a ``(1, 12, 4096, 4096)`` table; the
   share of 64 x 64 tile pairs the tensor-core bodies compute under the ids
   (``_tiles_meet``) beside the share of pairs visible; kernel, plain and
   library times (SDPA causal, with the packed mask as a boolean mask, and
   its backward with a float mask's gradient) beside the bounds over the
   pairs the ids leave visible, and ``flash_bwd_dkv`` with and without the
   folded dbias and the fold's second pass; then 3 steps of
   ``flash_attention(bias=, bias_requires_grad=True, segment_ids=,
   causal=True)``, the loss ``sum(out * dy)``, backward and
   ``FusedAdam(lr=1e-2)`` on the slopes, each launching ``flash_fwd``,
   ``flash_bwd_dq`` and ``flash_bwd_dkv`` once, the last with the folded
   dbias (``flash_dbias_fold`` once, ``flash_dbias`` never; in fp32
   ``flash_dbias`` once); step time and a profile; the plain path batch by
   batch, whose loss, dQ/dK/dV, slopes' grads and slopes must agree; and
   ``bench_flash_long``'s own call (no bias, no ids), timed;
16. ``train_lamb``: BERT-base pretraining as in 14 with the LAMB that
   ``TrainConfig`` builds for ``OptimizerConfig(name="lamb")`` at NVIDIA's
   BERT phase-1 values (lr 6e-3 held constant, betas (0.9, 0.999), eps
   1e-6, weight decay 0.01, max grad norm 1.0), ``DynamicLossScale(
   2**12)``: 4 steps, each launching the flash kernels 12 times and the
   LayerNorm kernels 26 times, every loss finite, each step's new params
   and LAMB state against the port's LAMB stepped on the CPU from the same
   grads, params and state; a ``FusedMixedPrecisionLamb`` leg over bf16
   copies of the params fed the scaled grads with the live loss scale,
   its masters against ``FusedLAMB`` on fp32 copies fed the unscaled
   grads; step ms, tokens/s, and the LAMB step's device ms, launches and
   copies (no device-to-host copy) beside ``FusedAdam``'s on the same
   grads;
17. ``optim_legs``: one forward and backward of GPT-small at 8 x 1024
   gives the grads; ``FusedNovoGrad`` (L2 and L-inf, both moment modes),
   ``FusedAdagrad`` (both modes), ``LARC(FusedSGD)`` and
   ``LARC(FusedAdam)`` 3 steps each on the card against the CPU,
   ``FlatOptimizer(FusedAdagrad)`` bit for bit with the per-leaf run; the
   ``multi_tensor_*`` flags (one injected ``inf``) and global norm
   (against ``torch.linalg.vector_norm``); the native ``flatten``/
   ``unflatten``/``gather_rows`` round trip with ``native_available()``
   true; then ``bench_headline``'s ResNet-50 step for 3 steps under
   ``LARC(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))`` (trust
   0.02, clip), step 0's update against the CPU;
18. ``transformer_ops``: a Transformer-big (fairseq's
   ``transformer_vaswani_wmt_en_de_big``: embed 1024, 16 heads, FFN 4096,
   shared vocab 32768, pad 1) encoder and decoder block over 28 sentences
   of 128 source and 96 target tokens, bf16, attention dropout 0.1 from
   seeds: ``SelfMultiheadAttn`` with norm-add and the padding mask, a
   residual ``FusedDenseGeluDense`` behind a LayerNorm, a causal
   ``SelfMultiheadAttn``, ``EncdecMultiheadAttn`` (96 against 128), the
   FFN, final LayerNorms, the tied projection and
   ``SoftmaxCrossEntropyLoss.apply(smoothing=0.1, padding_idx=1,
   half_to_float=True)``: 3 launches of each flash kernel and 7 of each
   LayerNorm kernel a forward and backward, the outputs, loss and grads
   against ``use_kernel=False`` on the card, a profile, and B1-B3 timed
   at the three attention shapes; ``FusedScaleMaskSoftmax`` at GPT-small's
   causal and BERT's padded scores within one bf16 ulp of an fp32 softmax
   (a fully masked row uniform); ``MLP([480, 1024, 1024, 512, 256, 1])``
   at batch 1024, fp32, card against CPU;
19. ``rnnt``: one MLPerf RNN-T training step (mlcommons/training
   ``rnn_speech_recognition/pytorch``, ``baseline_v3-1023sp.yaml``: 240
   features, an encoder of 2 + 3 LSTM layers of 1024 around a time
   stacking by 2, a 512 embedding and 2 LSTM layers of 512, the joint's
   projections to 512, ``TransducerJoint(relu=True)``, a linear to 1024
   classes, ``TransducerLoss``; batch 16, 534 frames, T 267, 125 labels,
   bf16 compute over fp32 params, ``FusedAdam``): 3 steps with finite
   losses, step ms, peak memory and a profile; the loss and step 0's
   grads against fp32 compute on the card; the transducer loss's forward
   and backward (host clock and device) and the joint; the encoder's
   first LSTM stack against cuDNN's ``nn.LSTM`` (a yardstick only); the
   transducer loss and an LSTM layer against the CPU at a reduced size;
20. ``retinanet_head``: MLPerf RetinaNet's classification head
   (mlcommons/training ``single_stage_detector``: ResNeXt50-32x4d FPN at
   800 x 800, P3-P7, 9 anchors, the 264 OpenImages classes) at batch 8,
   bf16: 4 ``conv_bias_relu`` and a ``conv_bias`` to 9 x 264 a level,
   ``focal_loss`` (alpha 0.25, gamma 2) on targets ~1% positive, ~5%
   ignored, the rest all-negative: forward + backward ms, focal loss's
   own, a profile, peak memory; the loss and grads against fp32 on the
   card; ``focal_loss`` on the class axis padded to 272; the frozen-BN
   convs at a res2 block's shapes and the masked conv at P3, timed; each
   op against the CPU at batch 1 on P5;
21. ``asp_gpt``: GPT-small as in 11 under ASP: masks on the card equal to
   the CPU's bit for bit, pruned, ``FusedAdam`` wrapped by
   ``init_optimizer_for_pruning``, 3 steps and one forced to overflow,
   every pruned entry 0 and every group of 4 at most 2 nonzeros after
   each; step ms and launches beside the unmasked step's; ``permute=True``
   on one layer's ``fc1`` weight;
22. ``tp1_gpt``: ``model_parallel_seed(1234)``, one GPT-small layer with
   dropout from ``get_rng_tracker().fork()``, under ``checkpoint`` bit for
   bit the unwrapped layer (and recomputed), a second fork new masks;
   ``vocab_parallel_cross_entropy`` on GPT-small's logits against
   ``softmax_cross_entropy_loss`` and the smoothing formula;
23. ``ddp_gpt`` (NCCL at world 1, ``parallel_state``'s mesh over one
   rank): ``train``'s GPT-small step with its grads synced by
   ``DistributedDataParallel(bucket_bytes=DEFAULT_BUCKET_BYTES)`` against
   the same step unsynced, in turns: 4 losses and step 0's grads bit for
   bit, step ms, buckets and bytes reduced a step, the NCCL kernels'
   launches and device ms in a profile; ``accumulate_gradients`` over 2
   microbatches of 4 x 1024 against the window by hand, bit for bit;
24. ``zero_gpt`` (NCCL at world 1): the step, at ``DIST_LAYERS`` (2)
   layers of GPT-small's widths (as 25 and 30's ZeRO ranks: the
   references they are held to), with the ZeRO-1 Adam that
   ``TrainConfig(zero=1, ddp_bucket_bytes=4 MiB)`` builds against
   ``FusedAdam``, in turns: 5 losses within ``TOL_ZERO_LOSS``, step ms,
   optimizer-state bytes a rank;
25. ``dist_ranks``: two processes on the card over gloo (CUDA tensors; the
   kernels built above, loaded by each rank;
   ``apex_tpu_torch.parallel._spawn.RankPool``, one pool of two ranks
   for 25-27 and 29-30; GPT-small's widths at ``DIST_LAYERS`` layers):
   DDP at 4 x 1024 a rank
   against the world-1 step at 8 x 1024 within ``TOL_TRAIN_*``, both
   ranks' grads alike; ZeRO at world 2 (a rank's shard half of world 1's,
   its moments after step 0 within ``TOL_ZERO_MOMENTS`` of Adam's on the
   DDP-averaged grads, 5 losses within ``TOL_TRAIN_LOSS`` of
   ``zero_gpt``'s), then a NaN in
   rank 1's grads making both ranks skip; ``SyncBatchNorm`` at a
   ResNet-50 BN shape (2 x 128 x 64 x 56 x 56, and 96 + 160 images)
   against the whole batch on one rank within ``TOL_SYNCBN``; the gloo
   times printed as gloo over loopback, no multi-GPU speed;
26. ``tp_gpt``: tensor parallelism at tp 2, two processes on the card
   over gloo as in 25 (the ring's hops staged through host tensors, as
   ``collective_matmul`` does on gloo): GPT-small's widths at
   ``TP_LAYERS`` (2) layers (26-28 run a cut depth: gloo stages every
   hop through the host) from seed 0 cut by
   ``_bridge.split_tp_state``, 4 x 1024 (rank 0's batch through
   ``broadcast_data``), bf16 over fp32 params, ``FusedAdam`` and
   ``DynamicLossScale`` with the finite flag reduced over the tensor
   group; three legs (plain TP, SP, SP with ``tp_comm_overlap``) of 3
   steps each: step 0's loss within ``TOL_TP_LOSS`` and its grads leaf by
   leaf within ``TOL_TP_GRAD`` of the one-rank tp = 1 step on the same
   weights and batch, SP and overlap against plain TP within the same
   limits, each rank's launches (one of each flash kernel a layer, two
   of each LayerNorm kernel a layer and the final one, a step), ``tp/collective_bytes`` against
   ``tp_overlap_fwd_bytes`` and the bytes the forward's hops moved, the
   host-clock step ms (gloo over loopback); a 2-layer d-64 fp32 model's
   overlap loss and grads bit for bit its fused SP ones; a NaN in rank
   1's grads skipping the step on both ranks; B1-B3 at 6 local heads
   ``(4, 6, 1024, 64)`` against their plain versions;
27. ``pp_gpt``: pipeline parallelism at pp 2, two processes on the card
   over gloo as in 25 (the stage hops staged through host tensors):
   GPT-small's widths at ``PP_LAYERS`` (4) layers from seed 0, 2 a
   stage, ``train``'s 8 x 1024 batch as
   4 microbatches of 2 x 1024 with the embedding on the first stage and
   the final LayerNorm, tied head and loss on the last (``GPTModel.
   pipeline_fns``): step 0's loss and every grad leaf of 1F1B against the
   one-rank ``forward_backward_no_pipelining`` on the same weights (the
   leaves bit for bit counted, any gap within ``TOL_TRAIN_*``), the
   all-forward order and the interleaved schedule (2 chunks a rank, 4
   stages of 1 layer) against it and bit for bit against 1F1B by
   digest; each rank's peak memory under 1F1B and the all-forward order
   at M 4 and 8 (1F1B's within ``PP_PEAK_SLACK``, the all-forward
   order's growing by ``PP_GROWTH_SHARE`` of 4 more microbatches'
   graphs at least); each run's launches against the schedule's
   (``pp_launches``); 3 steps of ``FusedAdam``
   and ``DynamicLossScale`` with the finite flag over the pipeline group,
   the host-clock step ms (gloo over loopback), and a NaN in rank 1's
   grads skipping both ranks;
28. ``hybrid_gpt``: ``GPTHybridTrainer`` from a ``TrainConfig`` (O2, adam)
   at tp 2 x pp 2 x dp 1, four processes on the card over gloo:
   GPT-small's widths at ``HYBRID_LAYERS`` (2) layers from seed 0, 2
   microbatches of 2 x 1024 (``tp_gpt``'s batch): step 0's loss and
   grads against the one-rank tp = 1 step on the same weights and batch
   within ``TOL_TP_*``, every rank's losses over 2 steps equal, the
   launches a rank a step (``pp_launches``), the step ms, and a NaN in
   rank 1's grads skipping all four;
29. ``cp_attention``: context parallelism at cp 2, two processes on the
   card over gloo (the ring's k/v hops and the all-to-alls staged through
   host tensors): the long-context shape ``(8, 12, 4096, 64)`` bf16,
   causal, 2048 positions a rank; ``ring_attention`` (remat on) and
   ``ulysses_attention`` forward and backward, each rank's output and
   q/k/v grads against the one-rank ``flash_attention`` on the whole
   sequence (the kernel) and its plain twin within ``TOL_CP``; B1-B3
   launches a rank (Ulysses: 1 + 2 a call, the ring none), host-clock ms,
   peak MiB a rank, bytes a hop and an all-to-all;
30. ``ep_spatial`` on the same two processes: ``ExpertParallelMLP`` at
   GPT-small's widths (768, ffn 3072), 8 experts, capacity 1.25, 8 x 1024
   tokens a rank, fp32 and bf16: output, aux loss and grads against the
   same two shards routed on one process each (a one-rank group, all 8
   experts; the expert grads summed over the ranks) within ``TOL_MOE``,
   output and aux against ``moe_dense`` (top-1 routing and each expert's
   FFN per token in fp32, written apart from the layer) within
   ``TOL_MOE_DENSE``, the tokens dropped, the host-clock ms;
   ``spatial_conv2d`` at
   ResNet-50's 3x3 shapes (32 x 56 x 56 x 64 at stride 1, the
   128-channel stride-2 conv) over a height split in two against the
   dense ``F.conv2d`` (forward, input and weight grads) within
   ``TOL_SPATIAL``; and ZeRO-1 (``zero_config``, ``DIST_LAYERS``
   layers) at dp 2: 2 steps, then
   ``save_checkpoint`` of the state;
31. ``checkpoint_resume``: GPT-small as ``train`` builds it (8 x 1024,
   ``FusedAdam``, ``DynamicLossScale``, bf16 compute over fp32 params,
   dropout from an ``RNGStatesTracker`` stream at the last step): 5 steps
   straight against 3 steps, ``save_checkpoint`` (``fp32_on_disk``,
   ``keep_last=1``), a fresh model, optimizer, scaler and tracker,
   ``restore_checkpoint`` and 2 more: every loss and every leaf bit for
   bit; the same through ``AsyncCheckpointer`` under ``FaultPlan(
   save_errors={3: 1}, tear_after_step=5)`` (``keep_last=2``; steps 4 and
   5 run while the writer writes step 3): the retry counted, the restore
   falling back past the torn step 5 with the warning, bit for bit again,
   the snapshot ms on the step thread against the serialize ms off it
   and the bytes; the dp 2 ZeRO checkpoint of 30 restored at world 1
   through ``reshard_zero_state``: each rank's shard bit for bit, and the
   master's natural flat vector at dp 1 bit for bit the fp32 params the
   ZeRO run gathered after its steps;
   ``watch_checkpoints`` on a dense ``ServingEngine`` rolls onto the
   committed step (``serve/swaps`` 1), and its greedy stream equals that
   of an engine built on the restored weights;
32. ``elastic`` E1 (NCCL at world 1 in this process): GPT-small at full
   width through ``TrainConfig`` (O2, adam) as ``GPTHybridTrainer`` at tp
   = pp = dp = 1 under ``ElasticRunner`` (``save_interval`` 2), fed by
   ``ShardedIndexIterator`` -> ``PrefetchingIterator(device="cuda")`` ->
   ``token_batch_fetcher`` over a seeded token array, 8 x 1024 tokens a
   step: 6 straight steps; in a fresh directory a ``FaultPlan(
   sigterm_at_step=3, slow_save_s=0.5)`` preemption (step 2's save still
   being written) and a fresh runner to step 6, whose losses, params,
   optimizer state, loss scale (sha256) and data cursor must equal the
   straight run's bit for bit, ``restored_from`` 3; each run's launches
   (B1-B3 12 a step, B7/B8 25); ``resume/restore_ms`` and the ``ckpt/*``
   metrics; then (at 2 layers of its widths) a second SIGTERM during the
   slowed drain of step 3's save raising ``DrainInterrupt``, step 2 the
   latest COMMITTED one;
33. ``elastic`` E2: the port's ``LocalLauncher(num_processes=2,
   min_processes=1, max_restarts=1)`` over ``chip_smoke.py
   --elastic-worker`` (two processes sharing the card over gloo;
   GPT-small's widths at 2 layers, ZeRO-1 Adam at dp 2) with ``FaultPlan(
   kill_process={1: 3})``, 4 steps: rank 1 SIGKILLed at step 3 twice,
   the gang shrunk to world 1, the survivor restoring the dp 2 checkpoint at dp 1
   (``FitResult.resharded``) and finishing; the ``LaunchReport``, each
   round's wall seconds, the first round's postmortem naming rank 1
   (``heartbeat_dead``), the aggregator's merged ``train/steps``; then in
   this process the same restore replayed from the same checkpoint (its
   losses and final state bit for bit the survivor's) and an
   uninterrupted dp 1 run from step 0 (the post-shrink losses within
   ``TOL_SHRINK_LOSS``);
34. ``observability`` O1: GPT-small's training step as ``train`` takes it
   (8 x 1024, bf16 compute, FusedAdam, DynamicLossScale, ``all_finite``,
   the skip) under ``ingraph.collecting()`` and ``health.activate(
   HealthConfig(level))``: three trainers from one state at off, cheap and
   full, a warm step then 3 each, the levels in turns, through one
   ``StepReporter`` (``JSONLSink``, ``ChromeTraceSink``, ``Timers`` timing
   the step with ``wait_for``, captured spans, a ``HealthConfig(full,
   raise)`` hook, ``flops_per_step`` from ``bench.py``'s analytic count,
   the compile listeners and ``sample_memory_stats`` each step): losses,
   params and optimizer state bit for bit across the levels; off records
   no ``health/*``, cheap the five ``health/grads/*`` keys (0 non-finite,
   first leaf -1), full ``optim_grads`` and ``params`` too; ``perf/mfu``
   equal to ``costs.mfu`` of the reporter's own step and time deltas;
   ``memory/bytes_in_use/device0`` within ``OBS_MEM_SLACK`` of
   ``memory_allocated()``; every JSONL line strict JSON; the trace's
   spans the timer's stops. Then each level's launches a step under the
   profiler (off launching what the bare step and the collector alone
   launch), median step ms, and ``flops_budget`` (FlopCounterMode, blind
   to the ctypes flash kernels) and ``memory_budget`` of a step;
35. ``observability`` O2: an overflow planted in ``layers.5.fc1.weight``
   (the loss gains ``sum(w) * inf``) at cheap: with ``on_nonfinite=
   "raise"`` the skip keeps params and optimizer state (sha256), the
   ``NonFiniteError`` and the strict-JSON crash dump name the leaf; with
   ``"dump"`` and ``consecutive=2`` one overflow writes no dump, two in a
   row write one;
36. ``observability`` O3: ``utils.timers.profile_trace`` around two cheap
   steps: the Chrome trace's kernel events of B1-B3 and B7/B8 equal to
   the launch counter's over the same steps;
37. ``observability`` O4: ``GPTHybridTrainer`` at tp = pp = dp = 1 (NCCL at
   world 1, 2 layers of GPT-small's widths) with ``TrainConfig(
   health_level="full")``: ``health/params/replica_divergence`` and
   ``health/ddp_grads/replica_divergence`` 0.0, the losses the bits of
   the same trainer at off;
38. a ``kernels`` JSON line (each kernel's ``body``: ``mma.sync bf16 /
   SIMT fp32`` for the three flash kernels, ``SIMT, split over
   positions`` for the two decode kernels, which also list the head dims
   they take, the fold and the table route for ``flash_dbias``, whose
   ``launches`` count both, ``SIMT`` for the rest), then
   ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import math
import re
import subprocess
import sys
import time

# H100 SXM published peaks (NVIDIA data sheet; dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
BF16_OPS_PER_S = 989e12
FP32_OPS_PER_S = 67e12       # outside the tensor cores

# tolerances, kernel vs plain on identical inputs, element by element:
# |kernel - plain| <= atol + rtol * |plain|, and over a whole output
# ||kernel - plain|| / ||plain|| <= the relative-norm limit. bf16
# outputs: both versions accumulate in fp32 and round once to bf16, so
# they differ by one bf16 ulp (at most 2**-7 of the value) where their
# fp32 sums fall on two sides of a rounding point; the backward kernels'
# fp32 sums differ by summation order only (under 1e-7 here). flash_fwd's
# also differ by the rounding of each probability to bf16 before the P V
# product: the kernel rounds the unnormalized ones (as the TPU kernel
# does), the plain version the normalized ones. bf16 keeps 8 significant
# bits, so a rounding moves a value by at most 2**-8 of it (half its ulp
# of up to 2**-7), each version's sum by at most 2**-8 * sum_j p_j |v_j|,
# and the two apart by at most 2**-7 * sum_j p_j |v_j|: the plain version
# run on |v| in fp32, which the check adds to atol element by element
# (``fwd_slack``). fp32 outputs: summation order only. Every lse: fp32,
# absolute.
BF16_TOL = (1e-3, 2 ** -7, 1e-2)     # (atol, rtol, relative norm)
FP32_TOL = (1e-5, 1e-5, 1e-5)
FWD_P_ROUNDING = 1.05 * 2 ** -7      # 5% over 2**-7 for fp32 summation
TOL_LSE = 1e-4
# plus two fp32 ulps of the value where the bias makes lse large (the
# long-context ALiBi row reaches ~2580, where one ulp is 2.4e-4)
TOL_LSE_REL = 2 ** -22
# teacher-forced GPT-small logits, kernel path vs plain path: bf16
# activations whose attention outputs differ by a few ulps per layer,
# carried through 12 residual layers and the tied head (|logit| ~ 1)
TOL_LOGITS = 0.1
# GPT-small training, kernel path vs plain path from one state dict: the
# per-step losses (~9-10, a mean over 8192 tokens; they differed by at
# most 1.4e-4 on an H100), and step 0's unscaled grads, leaf by leaf, as
# ||kernel - plain|| / ||plain|| (0.011 at the worst leaf, the tied
# embedding, 0.003 at the median one): bf16 attention outputs that differ
# by an ulp here and there, through 12 layers forward and back
TOL_TRAIN_LOSS = 1e-3
TOL_TRAIN_GRAD = 2e-2
TRAIN_STEPS = 4
TRAIN_COMPARE_STEPS = 3

# attention at the training shape: (batch x heads, seq, seq, head dim)
TRAIN_BH = (8, 12)
TRAIN_ATTN = (96, 1024, 1024, 64)
TRAIN_DROPOUT = 0.1
# what each kernel runs on: the three flash kernels take a bf16 body on the
# tensor cores and an fp32 one on the SIMT pipes, the rest one SIMT body
BODY = {"flash_fwd": "mma.sync bf16 / SIMT fp32",
        "flash_bwd_dq": "mma.sync bf16 / SIMT fp32",
        "flash_bwd_dkv": "mma.sync bf16 / SIMT fp32",
        "flash_dbias": "bf16 row bias: folded into flash_bwd_dkv's mma.sync "
                       "body + a fixed-order second pass (csrc/flash_dbias.cu"
                       "; the row's times are the folded launch's, dK and dV"
                       " included); tables and fp32: SIMT flash_dbias",
        "decode_attention": "SIMT, split over positions",
        "paged_decode_attention": "SIMT, split over positions",
        "ln_bwd": "SIMT, sized for occupancy"}
REPLACES = {"flash_fwd": "apex_tpu/ops/flash_attention.py:222",
            "flash_bwd_dq": "apex_tpu/ops/flash_attention.py:340",
            "flash_bwd_dkv": "apex_tpu/ops/flash_attention.py:411",
            "flash_dbias": "apex_tpu/ops/flash_attention.py:370",
            "decode_attention": "apex_tpu/ops/flash_attention.py:1021",
            "paged_decode_attention": "apex_tpu/ops/flash_attention.py:1384"}

# LayerNorm kernels: the path shape (tokens x hidden of the BERT and GPT
# training steps), one wide-row shape (one block per row) and BERT's eps.
# dweight/dbias in fp32 are sums over the 8192 rows in different orders:
# |kernel - plain| <= 1e-4 + 1e-5 |plain| per element (sums of ~90, near-0
# sums keep the terms' absolute rounding) and 1e-5 relative norm
LN_PATH = (8192, 768)
LN_WIDE = (1024, 16384)
# widths just past each kernel template's reach (csrc/layer_norm.cu: the
# forward's 8, 32 and 128 values a lane, the backward's 8, 16, 24 and 32,
# the warp kernels' limits of 1024 and 4096), whose last columns a template
# sized from h / 32 rounded down would leave out, and the narrowest width
# taken; 1001 rows leave a partial block of rows
LN_EDGE_ROWS = 1001
LN_EDGE_WIDTHS = (8, 264, 520, 776, 1032, 4104)
LN_EPS = 1e-12
LN_PARAM_GRAD_TOL = (1e-4, 1e-5, 1e-5)
LN_COPIES = 6              # input sets the timing rotates through
LN_PER_GPT_PASS = 25       # ln1 and ln2 in 12 layers, the final LN
LN_PER_BERT_PASS = 26      # and the MLM head's LN

# BERT-base pretraining (google-research/bert uncased_L-12_H-768_A-12):
# 16 sequences of 512 positions, lengths drawn in 256-512. Kernel path vs
# plain path from one state dict: step 0's loss (~11.2) within 1e-3 and its
# grads within 2e-2 relative norm per leaf, GPT's limits (the same bf16
# attention outputs an ulp apart through 12 layers; the LayerNorm kernels
# round where their twins do). The later steps' losses within 1e-2: with
# no warmup, Adam's first steps move every element by ~lr whatever its
# grad's size, so grads at rounding level move apart by up to 2 lr, and
# the loss swings by over a nat a step (11.17, 12.29, 12.93 on the card,
# both paths). Set after the first full run read 2.0e-4, 4.4e-3 and
# 2.5e-3.
BERT_BH = (16, 12)
BERT_ATTN = (192, 512, 512, 64)
BERT_LENGTHS = (256, 512)
BERT_STEPS = 4
BERT_COMPARE_STEPS = 3
TOL_BERT_LOSS = (1e-3, 1e-2)          # step 0, later steps
TOL_BERT_GRAD = 2e-2

# flash_dbias: (b, h, s) of its checks at the bias shapes of
# tests/test_flash_attention.py:133-139 and (b, 1, 1, sk). Its fp32 output
# sums up to R x sq (32768 on the long-context path) fp32 score cotangents,
# which kernel and twin each compute from the same inputs (dot products
# that differ by summation order, ~1e-7 relative) and add in different
# orders: |kernel - plain| <= 1e-5 max|plain| + 1e-5 |plain| element by
# element and 1e-5 relative norm (the first chip run read at most 2.2e-7
# of max|plain| and 1.2e-7 relative norm at 2 x 3 x 128 x 128)
DBIAS_BH_S = (2, 12, 512)
# which of (batch, heads, query rows) each bias holds in full: (1, h, sq,
# sk), (b, h, sq, sk), (1, 1, sq, sk), (b, 1, sq, sk), (1, h, 1, sk), (b, 1,
# 1, sk)
DBIAS_SHAPES = ((False, True, True), (True, True, True), (False, False, True),
                (True, False, True), (False, True, False),
                (True, False, False))
DBIAS_TOL = (1e-5, 1e-5, 1e-5)   # (atol as a share of max|plain|, ...)

# the long-context path: bench.py::bench_flash_long's shape (8 x 12 heads,
# 4096 positions, d 64, bf16, causal) with 4 packed documents a row and a
# learned ALiBi row bias whose slopes FusedAdam trains for 3 steps
LONG_SHAPE = (8, 12, 4096, 64)
LONG_DOCS = 4
LONG_STEPS = 3
LONG_LR = 1e-2
# kernel path vs plain path (batch by batch), bf16, the plain path from
# the kernel path's slopes at each step: the loss sum(out * dy) over 25.2 M
# terms, whose bf16 outputs differ by roundings of either sign, so the
# difference grows as the square root of the count: ~1e-6 of
# sum |out * dy| expected, 1e-5 allowed; dQ/dK/dV by relative norm as the
# kernel checks' bf16 limit (1e-2).
# The slopes' grad sum_j j * dbias[h, j] is not held in bf16: per row,
# sum_j ds equals the rounding error of delta = rowsum(do * out) taken from
# the bf16 output, and the row bias weights it by j (up to 4095), so the
# roundings of the two paths' outputs alone move it by as much as its
# value (the first chip run read 0.52 of its norm apart, signs flipped).
# The same path in fp32, whose outputs round 2**16 times finer, holds it:
# the loss within 1e-6 of sum |out * dy|, dQ/dK/dV 1e-4 and the slopes'
# grad 1e-3 by relative norm (sums of 3.3e8 visible scores in other
# orders), the slopes after each step within 1e-4 (Adam moves a slope by
# ~lr = 1e-2 a step, times the grads' relative difference)
TOL_LONG_LOSS = 1e-5
TOL_LONG_DQKV = 1e-2
LONG_TOL_FP32 = {"loss": 1e-6, "dqkv": 1e-4, "grad": 1e-3, "slopes": 1e-4}
# the folded dbias at the long shape is also held under DBIAS_TOL on these
# seeds' inputs (RandomState(seed), as the path's) and under the path's
# slopes times these (the ALiBi row up to ~5160 and ~10320)
LONG_FOLD_SEEDS = (1, 2, 3)
LONG_FOLD_STEEPER = (2, 4)

PROMPT_LENS = [1, 128, 17, 64, 100, 5, 33, 128, 77, 2, 90, 45, 120, 9, 60,
               127]
NEW_TOKENS = 32
# the JAX bench's BENCH_DECODE_CONFIGS["gpt_decode_paged"] (bench.py:943)
PAGED = dict(max_seqs=8, max_len=1024, prefill_len=128, block_size=128,
             num_blocks=65)
SHARED_REPEATS = 4     # greedy requests repeating one 128-token prompt


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float, fp32_ops: float = 0.0):
    """Least time (ms) the card could take for bf16 work: bytes over HBM
    bandwidth vs operations over the bf16 tensor-core peak, plus any fp32
    operations outside the tensor cores over their peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / BF16_OPS_PER_S + fp32_ops / FP32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def tol_for(torch, dtype):
    return BF16_TOL if dtype == torch.bfloat16 else FP32_TOL


def close(torch, pairs, tol, slack=None) -> tuple:
    """Max abs error over ``(kernel, plain)`` pairs, and the largest share
    of a limit that any element or output uses (at most 1 passes): of the
    element-wise ``atol + slack + rtol * |plain|`` (``slack`` a tensor
    like the plain output, or None) and of the relative-norm limit."""
    atol, rtol, rel = tol
    err = share = 0.0
    for got, want in pairs:
        if not want.numel():
            continue
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        limit = atol + rtol * w.abs()
        if slack is not None:
            limit = limit + slack
        err = max(err, float(diff.max()))
        share = max(share, float((diff / limit).max()),
                    float(diff.norm() / w.norm().clamp(min=1e-30)) / rel)
    return err, share


def fwd_slack(torch, fa, q, k, v, causal, scale, rate=0.0, seed=None,
              bias=None):
    """``flash_fwd``'s extra element-wise slack on bf16 outputs:
    ``FWD_P_ROUNDING * sum_j p_j |v_j|`` (see the tolerances above)."""
    if v.dtype != torch.bfloat16:
        return None
    pv, _ = fa._flash_fwd_plain(q.float(), k.float(), v.abs().float(),
                                causal, scale, rate, seed, bias=bias)
    return FWD_P_ROUNDING * pv


def compare_lse(torch, lse_k, lse_p, tol: float, what: str,
                rel: float = 0.0) -> float:
    """Max abs lse error; each finite row within ``tol + rel * |lse|``."""
    inf_k, inf_p = torch.isinf(lse_k), torch.isinf(lse_p)
    check(bool((inf_k == inf_p).all()), f"{what}: infinite lse rows differ")
    check(bool((lse_k[inf_k] == lse_p[inf_p]).all()),
          f"{what}: infinite lse signs differ")
    fin = ~inf_k
    err = max_err(torch, lse_k[fin], lse_p[fin])
    limit = tol + rel * lse_p[fin].abs()
    check(bool(((lse_k[fin] - lse_p[fin]).abs() <= limit).all()),
          f"{what}: lse err {err:.3g} over {tol} + {rel} |lse|")
    return err


# On an H100, torch.profiler's windows here lose the device records of
# their first launches: none early in a run, up to ~20 later, whatever the
# sleep before the first call (5, 20, 80 ms) or a warm-up step traced and
# dropped (PERF.md). So every window opens with PROFILE_PRIMERS launches on
# a one-element tensor and a synchronize, which take that loss and are left
# out of what is read. A window in which a launch call past them has no
# kernel, or that holds fewer kernels than calls or fewer of the port's
# kernels than its wrappers counted, is taken again, and the third such
# window fails the run.
PROFILE_TRIES = 3
PROFILE_PRIMERS = 256
# the host's launch calls, as the profiler records the CUDA runtime's and
# driver's API: each must have its kernel on the device, by correlation id
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
                "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
# the namespace of every kernel in the port's CUDA sources (apex_tpu_torch/
# csrc), as the profiler names them
PORT_NAMESPACE = "apex_port::"
# over the run: windows read, windows taken again, and the most primer
# records one window lost (printed before the last lines)
PROFILER_STATS = {"windows": 0, "retaken": 0, "primers_lost": 0}


def profile_window(torch, fn, iters: int, what: str) -> tuple:
    """``(rows, wall ms, primers lost)`` of ``iters`` calls of ``fn`` in one
    ``torch.profiler`` window recording CUDA activity alone (host events
    slow a step of ~100k launches to seconds), from its raw events
    (``key_averages()`` left a kernel out of a serving window whose every
    launch call had its kernel): ``rows`` are ``(name, device ms a call,
    count a call)`` of what the calls ran on the device (kernels, copies,
    memsets), most time first; the wall time a call is the host's
    ``perf_counter`` over the calls and their synchronize; ``primers
    lost`` the primer launches whose records the window lost.

    A window is short when a launch call of the calls has no kernel of its
    correlation id, when the primers' records hold another kernel than
    theirs, or when it holds fewer kernels than calls or fewer of the
    port's kernels than its wrappers counted (one a launch;
    ``flash_dbias_fold`` is left out, as it counts a mode of a
    ``flash_bwd_dkv`` launch that folds in that kernel when it takes one
    split)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from apex_tpu_torch import _kernels as kern

    def wrapped() -> int:
        return sum(n for name, n in kern.LAUNCHES.items()
                   if name != "flash_dbias_fold")

    primer = torch.zeros(1, device="cuda")
    for attempt in range(PROFILE_TRIES):
        counted = wrapped()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_PRIMERS):
                primer.add_(1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0) / iters
        counted = wrapped() - counted
        events = list(prof.profiler.kineto_results.events())
        device = [e for e in events if e.device_type() == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", bool)()]
        ran = {e.correlation_id() for e in device
               if not e.name().startswith(("Memcpy", "Memset"))}
        calls = sorted((e for e in events if e.name() in LAUNCH_CALLS),
                       key=lambda e: e.start_ns())
        primed = {e.correlation_id() for e in calls[:PROFILE_PRIMERS]}
        calls = calls[PROFILE_PRIMERS:]
        primers_lost = len(primed - ran)
        missing = [i for i, e in enumerate(calls)
                   if e.correlation_id() not in ran]
        primer_names = {e.name() for e in device
                        if e.correlation_id() in primed}
        read = [e for e in device if e.correlation_id() not in primed]
        kernels = sum(not e.name().startswith(("Memcpy", "Memset"))
                      for e in read)
        port = sum(PORT_NAMESPACE in e.name() for e in read)
        PROFILER_STATS["windows"] += 1
        PROFILER_STATS["primers_lost"] = max(PROFILER_STATS["primers_lost"],
                                             primers_lost)
        if (not missing and len(primer_names) <= 1 and kernels >= iters
                and port >= counted):
            rows = {}
            for e in read:
                ns, c = rows.get(e.name(), (0, 0))
                rows[e.name()] = (ns + e.duration_ns(), c + 1)
            return sorted(((name, ns / 1e6 / iters, c / iters)
                           for name, (ns, c) in rows.items()),
                          key=lambda r: -r[1]), wall_ms, primers_lost
        PROFILER_STATS["retaken"] += 1
        print(f"{what}: profiler window {attempt + 1} of {PROFILE_TRIES} "
              f"over {iters} calls is short: {primers_lost} of "
              f"{PROFILE_PRIMERS} primer records lost, {len(missing)} of "
              f"{len(calls)} launch calls with no kernel (at {missing[:8]}"
              f"{' ...' * (len(missing) > 8)}), {kernels} kernels read, "
              f"{port} of the port's for {counted} counted by its wrappers, "
              f"{len(primer_names)} kernel names among the primers'")
    check(False, f"{what}: {PROFILE_TRIES} profiler windows in a row lost "
                 "device events")


def device_ms(torch, fn, iters: int = 10, show: str = "") -> float:
    """Device time per call of ``fn``: the kernels it launches, summed over
    ``iters`` calls in a ``profile_window`` after two warm-up calls.
    Kernel, plain and library calls are all timed so, since a call's host
    dispatch can outlast its kernels (CUDA events around back-to-back
    calls would then time the host). With ``show``, prints the kernels
    that took the most time, so the backend is on record."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    rows, _, _ = profile_window(torch, fn, iters, show or "device_ms")
    if show:
        print(f"{show} ran: " + "; ".join(
            f"{key[:60]} {ms:.4f} ms" for key, ms, _ in rows[:4]))
    return sum(ms for _, ms, _ in rows)


def event_ms(torch, fn, iters: int = 3) -> float:
    """Device time per call of ``fn`` from CUDA events around ``iters``
    back-to-back calls, after one warm-up. For the long-context shape,
    whose kernels run for tens of ms (host dispatch is noise there), and
    where ``torch.profiler`` inside this script returned no device time
    for them (alone on the card it agreed with these events)."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def same_bits(torch, what: str, first, again) -> None:
    """A second launch on the same inputs gave the same bits: ``first``
    and ``again`` are tuples of the launches' outputs."""
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(first, again)),
          f"{what}: a second launch differs")


def retaken(torch, kern, what: str, args, kw: dict, visible: int,
            dq) -> None:
    """How many scores the bf16 ``flash_bwd_dq`` body's rounding pass
    (``csrc/rounding.cuh``) took again on ``args``, of the ``visible``
    ones, from a diagnostic launch whose dq must equal ``dq`` bit for
    bit."""
    dq_diag, count = kern.flash_bwd_dq_retaken(*args, **kw)
    same_bits(torch, f"flash_bwd_dq at {what}, counting", (dq,), (dq_diag,))
    print(f"flash_bwd_dq rounding pass at {what}: {count} of {visible} "
          f"visible scores taken again ({count / visible:.3g})")


# csrc/flash_fwd.cu and csrc/flash_bwd.cu: the bf16 tensor-core bodies (the
# forward's kernel3 the launch held to three blocks an SM) and
# their dynamic shared memory a block (bf16 rows of W + 8 elements, W the
# body width: the
# 64-row q tile and two stages of 64 keys of K and V; q, do and two stages
# of K and V, plus two stages of 64 key ids and K and V norms, 4 bytes
# each; K, V and two stages of q and do, plus two stages of 64 lse, delta,
# query ids and q and do row norms)
MMA_KERNELS = {"flash_fwd_mma_kernel3": lambda w: 2 * 5 * 64 * (w + 8),
               "flash_fwd_mma_kernel": lambda w: 2 * 5 * 64 * (w + 8),
               "flash_bwd_dq_mma_kernel":
                   lambda w: 2 * 6 * 64 * (w + 8) + 4 * 2 * 3 * 64,
               "flash_bwd_dkv_mma_kernel":
                   lambda w: 2 * 6 * 64 * (w + 8) + 4 * 2 * 5 * 64}


# the template arguments of ln_bwd_warp_kernel<x, dy, w, values a lane> as
# mangled: fp32 is "f", __nv_bfloat16 its name or a substitution
LN_BWD_TYPES = r"f|13__nv_bfloat16|S\d*_"


def mma_resources(kern) -> None:
    """Registers, spills and shared memory of the tensor-core bodies (the
    dkv body's with and without the folded dbias) and of ``ln_bwd``'s row
    kernel, from ptxas's report in this build's log
    (``_kernels.build_log``)."""
    log = kern.build_log()
    found, ln = [], []
    for blk in log.split("Compiling entry function")[1:]:
        regs = re.search(r"Used (\d+) registers", blk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", blk)
        if not (regs and spill):
            continue
        use = (f"{regs.group(1)} registers, spill {spill.group(1)}/"
               f"{spill.group(2)} bytes")
        name = re.search(r"(" + "|".join(MMA_KERNELS) + r")"
                         r"ILi(\d+)ELb([01])ELb([01])E(?:Lb([01])E)?", blk)
        row = re.search(r"ln_bwd_warp_kernelI((?:" + LN_BWD_TYPES
                        + r"){3})Li(\d+)E", blk)
        if name:
            kname, w, dyn, seg, fold = name.groups()
            found.append(f"{kname}<width {w}"
                         f"{', d run-time' if dyn == '1' else ''}"
                         f"{', ids' if seg == '1' else ''}"
                         f"{', dbias fold' if fold == '1' else ''}> {use}, "
                         f"{MMA_KERNELS[kname](int(w))} B shared")
        elif row:
            types = "/".join("fp32" if t == "f" else "bf16" for t in
                             re.findall(LN_BWD_TYPES, row.group(1)))
            ln.append(f"<{types}, {row.group(2)} a lane> {use}")
    print("ptxas -v, the tensor-core bodies (128 threads a block; the dkv "
          "body 256 past width 64): "
          + ("; ".join(found) if found else
             "not in this build's log (built before this process)"))
    print("ptxas -v, ln_bwd_warp_kernel <x/dy/weight, values a lane> (256 "
          "threads a block): " + ("; ".join(ln) if ln else "not in this "
                                  "build's log"))


# csrc/decode.cuh: the split body's template arguments as mangled in
# (paged_)decode_kernel<q, cache, wide fp32, lanes a row, d fills the lanes,
# q rows>: fp32 "f", int8 "a", __nv_bfloat16 its name or a substitution
DECODE_TYPES = r"f|a|13__nv_bfloat16|S\d*_"


def decode_resources(kern) -> None:
    """Registers and spills of the two decode kernels' template instances
    from ptxas's report in this build's log: how many there are, the most
    registers and spill bytes of any, and the bf16 instances at d 64, 128
    and 256 (8, 16 and 32 lanes a row, filled) and fp32's past d 128."""
    log = kern.build_log()
    rows = []
    for blk in log.split("Compiling entry function")[1:]:
        name = re.search(r"\d+(paged_decode_kernel|decode_kernel)I((?:"
                         + DECODE_TYPES + r"){2})Lb([01])ELi(\d+)ELb([01])E"
                         r"Li(\d+)E", blk)
        regs = re.search(r"Used (\d+) registers", blk)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", blk)
        if not (name and regs and spill):
            continue
        kname, types, wide, lanes, full, r = name.groups()
        q_t, kv_t = ("fp32" if t == "f" else "int8" if t == "a" else "bf16"
                     for t in re.findall(DECODE_TYPES, types))
        rows.append((kname, q_t, kv_t, wide == "1", int(lanes), full == "1",
                     int(r), int(regs.group(1)),
                     int(spill.group(1)) + int(spill.group(2))))
    if not rows:
        print("ptxas -v, the decode kernels: not in this build's log (built "
              "before this process)")
        return
    for kname in ("decode_kernel", "paged_decode_kernel"):
        mine = [x for x in rows if x[0] == kname]
        shown = [f"{q_t}/{kv_t} {'8 fp32 a lane, ' if wide else ''}"
                 f"{lanes} lanes a row{', filled' if full else ''}, {r} q "
                 f"row(s): {regs} registers, spill {sp} bytes"
                 for _, q_t, kv_t, wide, lanes, full, r, regs, sp in mine
                 if (q_t, kv_t) == ("bf16", "bf16") and lanes >= 8 and full
                 or wide and q_t == "fp32"]
        print(f"ptxas -v, {kname} (128 threads a block): {len(mine)} "
              f"instances, at most {max(x[7] for x in mine)} registers, "
              f"spill {max(x[8] for x in mine)} bytes at most; "
              + "; ".join(shown))


def tile_shares(torch, fa, ids, causal: bool) -> tuple:
    """Tile pairs (64 x 64) of self-attention over ``ids (b, s)``: those
    the tensor-core kernels compute (inside the causal region and meeting
    by ``_tiles_meet``), the causal ones, and all of them."""
    meet = fa._tiles_meet(ids, ids)
    tiles = meet.shape[-1]
    region = torch.ones(tiles, tiles, dtype=torch.bool, device=ids.device)
    if causal:
        region = torch.tril(region)
    computed = int((meet & region).sum())
    return computed, ids.shape[0] * int(region.sum()), meet.numel()


# ---------------------------------------------------------------------------
# phase 3: kernels vs plain
# ---------------------------------------------------------------------------

def check_flash(torch, fa, kern, card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(1)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = [  # (name, n, sq, sk, d, causal, dtype)
        ("prefill path (1x12, 128, 128, d64) causal bf16", 12, 128, 128, 64,
         True, torch.bfloat16),
        ("ragged sq=sk=100 causal bf16", 6, 100, 100, 64, True,
         torch.bfloat16),
        ("cross sq=64 < sk=200 causal bf16", 6, 64, 200, 64, True,
         torch.bfloat16),
        ("cross sq=64 < sk=200 non-causal bf16", 6, 64, 200, 64, False,
         torch.bfloat16),
        ("fp32 d128 causal", 4, 128, 128, 128, True, torch.float32),
        ("fp32 d128 non-causal", 4, 96, 160, 128, False, torch.float32),
        ("fully masked rows sq=96 > sk=40 causal fp32", 4, 96, 40, 64, True,
         torch.float32),
    ]
    worst = 0.0
    for name, n, sq, sk, d, causal, dt in cases:
        q, k, v = (rand((n, s, d), dt) for s in (sq, sk, sk))
        scale = d ** -0.5
        out_k, lse_k = kern.flash_fwd(q, k, v, causal, scale)
        out_p, lse_p = fa._flash_fwd_plain(q, k, v, causal, scale)
        torch.cuda.synchronize()
        tol = tol_for(torch, dt)
        err, share = close(torch, [(out_k, out_p)], tol,
                           fwd_slack(torch, fa, q, k, v, causal, scale))
        check(share <= 1, f"flash_fwd {name}: out err {err:.3g}, "
                          f"{share:.3g} x the limit {tol}")
        lerr = compare_lse(torch, lse_k, lse_p, TOL_LSE, f"flash_fwd {name}")
        if sq > sk and causal:
            masked = sq - sk
            check(bool((out_k[:, :masked] == 0).all())
                  and bool(torch.isinf(lse_k[:, :masked]).all()),
                  "flash_fwd: fully masked rows are not 0 / +inf")
        print(f"flash_fwd  {name}: max_abs_err out {err:.3g}, {share:.3g} x "
              f"the limit {tol}; lse {lerr:.3g} (tol {TOL_LSE})")
        if n == 12:
            worst = max(worst, err)

    # timing at the prefill path shape
    n, s, d = 12, 128, 64
    q, k, v = (rand((n, s, d), torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    ms = device_ms(torch, lambda: kern.flash_fwd(q, k, v, True, scale))
    plain_ms = device_ms(torch,
                         lambda: fa._flash_fwd_plain(q, k, v, True, scale))
    q4, k4, v4 = (t.view(1, n, s, d) for t in (q, k, v))
    lib_ms = device_ms(torch, lambda: torch.nn.functional
                       .scaled_dot_product_attention(q4, k4, v4,
                                                     is_causal=True))
    pairs = s * (s + 1) // 2           # visible (row, col) pairs per head
    ops = 2 * 2 * pairs * d * n        # QK^T and PV, causal half only
    nbytes = nbytes_of(q, k, v, q) + n * s * 4   # q k v in, o + lse out
    b_ms, b_by = bound(nbytes, ops)
    print(f"flash_fwd  prefill path timing: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}) [{card}]")
    return {"name": "flash_fwd", "route": "cuda",
            "source": "apex_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "apex_tpu/ops/flash_attention.py:222",
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def check_decode(torch, fa, cache_mod, kern, card: str) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(2)

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    S, H, T, d = 8, 12, 1024, 64
    n = S * H
    path_lengths = torch.tensor([0, 1, 513, 1024, 7, 300, 1000, 64],
                                dtype=torch.int32, device="cuda")
    cases = []
    cases.append(("decode path (8x12, T 1024, d64) bf16",
                  rand((n, 1, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16), None, None,
                  path_lengths.repeat_interleave(H)))
    kq, ks = cache_mod._quantize(rand((n, T, d)))
    vq, vs = cache_mod._quantize(rand((n, T, d)))
    cases.append(("int8 cache with scales, bf16 q", rand((n, 1, d),
                                                         torch.bfloat16),
                  kq, vq, ks, vs, path_lengths.repeat_interleave(H)))
    cases.append(("q_len=4 bf16", rand((n, 4, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16),
                  rand((n, T, d), torch.bfloat16), None, None,
                  path_lengths.repeat_interleave(H)))
    lens9 = torch.tensor([0, 3, 77, 256], dtype=torch.int32, device="cuda")
    cases.append(("q_len=9 fp32 d128", rand((16, 9, 128)),
                  rand((16, 256, 128)), rand((16, 256, 128)), None, None,
                  lens9.repeat_interleave(4)))
    # the position split (csrc/decode_attention.cu): one slot (12 slot-heads,
    # 16 chunks of 64 of the 1024 positions) at every cursor around a chunk's
    # and the cache's edges, int8 at q_len 4, bf16 d 128 (inputs from their
    # own generator, so the cases above keep theirs)
    gen_split = torch.Generator(device="cuda").manual_seed(12)

    def rand_split(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen_split, device="cuda").to(
            dtype)

    q1 = rand_split((H, 1, d), torch.bfloat16)
    k1, v1 = (rand_split((H, T, d), torch.bfloat16) for _ in range(2))
    for cursor in (0, 1, 63, 64, 65, 1023, 1024):
        cases.append((f"one slot, cursor {cursor} bf16", q1, k1, v1, None,
                      None, torch.full((H,), cursor, dtype=torch.int32,
                                       device="cuda")))
    kq4, ks4 = cache_mod._quantize(rand_split((n, T, d)))
    vq4, vs4 = cache_mod._quantize(rand_split((n, T, d)))
    cases.append(("int8 cache with scales, q_len=4 bf16",
                  rand_split((n, 4, d), torch.bfloat16), kq4, vq4, ks4, vs4,
                  path_lengths.repeat_interleave(H)))
    cases.append(("bf16 d128 (8x12, T 1024)",
                  rand_split((n, 1, 128), torch.bfloat16),
                  rand_split((n, T, 128), torch.bfloat16),
                  rand_split((n, T, 128), torch.bfloat16), None, None,
                  path_lengths.repeat_interleave(H)))
    worst = 0.0
    bits = hashlib.sha256()
    for name, q, k, v, ksc, vsc, lengths in cases:
        scale = q.shape[-1] ** -0.5
        out_k, lse_k = kern.decode_attention(q, k, v, lengths, ksc, vsc,
                                             scale)
        same_bits(torch, f"decode_attention {name}", (out_k, lse_k),
                  kern.decode_attention(q, k, v, lengths, ksc, vsc, scale))
        for t in (out_k, lse_k):
            bits.update(t.contiguous().view(torch.uint8).cpu().numpy()
                        .tobytes())
        out_p, lse_p = fa._decode_plain(q, k, v, lengths, ksc, vsc, scale)
        torch.cuda.synchronize()
        tol = tol_for(torch, q.dtype)
        err, share = close(torch, [(out_k, out_p)], tol)
        check(share <= 1, f"decode_attention {name}: out err {err:.3g}, "
                          f"{share:.3g} x the limit {tol}")
        lerr = compare_lse(torch, lse_k, lse_p, TOL_LSE,
                           f"decode_attention {name}")
        empty = lengths == 0
        check(bool((out_k[empty] == 0).all())
              and bool((lse_k[empty] == float("-inf")).all()),
              "decode_attention: empty rows are not 0 / -inf")
        splits = kern.decode_splits(k.shape[0], k.shape[1], q.shape[1])
        print(f"decode_attention {name}: max_abs_err out {err:.3g}, "
              f"{share:.3g} x the limit {tol}; lse {lerr:.3g} "
              f"(tol {TOL_LSE}); {splits} chunks a slot-head; a second "
              "launch equal bit for bit")
        if q.shape[1] == 1 and k.dtype == torch.bfloat16:
            worst = max(worst, err)
    # the outputs' bits over these cases: equal before and after a change
    # that must leave the kernel's arithmetic as it is
    print(f"decode_attention bits: sha256 of out and lse over the "
          f"{len(cases)} cases above {bits.hexdigest()}")
    del cases, kq4, vq4, k1, v1

    t = decode_timings(torch, fa, kern, card)
    return {"name": "decode_attention", "route": "cuda",
            "source": "apex_tpu_torch/csrc/decode_attention.cu",
            "replaces": "apex_tpu/ops/flash_attention.py:1021",
            "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


# the cursors of the dense serving path's decode step halfway through its
# first 8 requests: their prompts (PROMPT_LENS) and 16 of the 32 new tokens
SERVE_CURSORS = tuple(p + NEW_TOKENS // 2 for p in PROMPT_LENS[:8])


def decode_timings(torch, fa, kern, card: str) -> dict:
    """``decode_attention`` (bf16, d 64, max_len 1024) timed beside its
    plain twin, SDPA and its bound: every one of 8 slots x 12 heads at the
    full prefix (the keys ``ms``, ``plain_ms``, ``library_ms``,
    ``bound_ms``, ``bound_by``), one slot at the full prefix, and 8 slots
    at :data:`SERVE_CURSORS` (SDPA with a boolean mask of the cursors).
    Takes the ``_kernels`` and ``ops.flash_attention`` modules, so
    another tree's kernel can be timed on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    S, H, T, d = 8, 12, 1024, 64
    n = S * H
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16) for shape in ((n, 1, d), (n, T, d),
                                                 (n, T, d)))
    scale = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q4, k4, v4 = q.view(S, H, 1, d), k.view(S, H, T, d), v.view(S, H, T, d)
    full = torch.full((n,), T, dtype=torch.int32, device="cuda")
    serve_lens = torch.tensor(SERVE_CURSORS, dtype=torch.int32,
                              device="cuda").repeat_interleave(H)
    serve_mask = (torch.arange(T, device="cuda")[None, :]
                  < serve_lens.view(S, H)[:, :1])[:, None, None, :]
    out = {}
    for what, heads, lengths, lib in (
            ("8 slots x 1024", n, full, lambda: sdpa(q4, k4, v4)),
            ("one slot x 1024", H, full[:H],
             lambda: sdpa(q4[:1], k4[:1], v4[:1])),
            (f"8 slots at the serving cursors {SERVE_CURSORS}", n,
             serve_lens, lambda: sdpa(q4, k4, v4, attn_mask=serve_mask))):
        args = (q[:heads], k[:heads], v[:heads], lengths, None, None, scale)
        ms = device_ms(torch, lambda: kern.decode_attention(*args))
        plain_ms = device_ms(torch, lambda: fa._decode_plain(*args))
        lib_ms = device_ms(torch, lib)
        live = int(lengths.sum())      # positions the lengths make live
        b_ms, b_by = bound(2 * live * d * 2
                           + nbytes_of(args[0], args[0], lengths)
                           + heads * 4, 2 * 2 * live * d)
        print(f"decode_attention timing, {what}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, bound {b_ms:.5f} "
              f"ms ({b_by}) [{card}]")
        out.setdefault("ms", ms)
        out.setdefault("plain_ms", plain_ms)
        out.setdefault("library_ms", lib_ms)
        out.setdefault("bound_ms", b_ms)
        out.setdefault("bound_by", b_by)
    return out


def check_paged(torch, fa, cache_mod, kern, card: str) -> dict:
    """``paged_decode_attention`` against ``_paged_decode_plain`` on the
    card, each launch repeated bit for bit, the poison case bit for bit,
    and timing (:func:`paged_timings`) beside the dense decode kernel at
    the same live context."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    cpu_gen = torch.Generator().manual_seed(4)

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def tables_for(num_blocks, slots, n_table):
        # each slot's blocks scattered through the pool, never block 0
        perm = torch.randperm(num_blocks - 1, generator=cpu_gen) + 1
        return perm[: slots * n_table].view(slots, n_table).to(
            device="cuda", dtype=torch.int32)

    def lens(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    S, H, bs, n_table, d = 8, 12, PAGED["block_size"], 8, 64
    nb = PAGED["num_blocks"]
    path_lengths = lens([0, 1, 513, 1024, 7, 300, 1000, 64])
    path_tables = tables_for(nb, S, n_table)
    kq, ks = cache_mod._quantize(rand((nb, H, bs, d)))
    vq, vs = cache_mod._quantize(rand((nb, H, bs, d)))
    path = ("paged path (8 slots x 12 heads, 8 blocks of 128, d64) bf16",
            rand((S * H, 1, d), torch.bfloat16),
            rand((nb, H, bs, d), torch.bfloat16),
            rand((nb, H, bs, d), torch.bfloat16), None, None, path_tables,
            path_lengths)
    cases = [
        path,
        ("int8 pool with scales, bf16 q", rand((S * H, 1, d), torch.bfloat16),
         kq, vq, ks, vs, path_tables, path_lengths),
        ("q_len=5 bf16", rand((S * H, 5, d), torch.bfloat16), *path[2:]),
        ("fp32 d128, 16-token blocks", rand((16, 1, 128)),
         rand((65, 4, 16, 128)), rand((65, 4, 16, 128)), None, None,
         tables_for(65, 4, 16), lens([0, 3, 77, 256])),
        ("48-token blocks, q_len=3 bf16", rand((16, 3, d), torch.bfloat16),
         rand((25, 4, 48, d), torch.bfloat16),
         rand((25, 4, 48, d), torch.bfloat16), None, None,
         tables_for(25, 4, 6), lens([0, 47, 48, 288])),
    ]
    # chunks that start and end inside 48-token blocks (4 chunks a
    # slot-head over a span of 288: chunk edges at multiples of 2, 26, 63
    # and 72, an empty chunk at cursor 5), and 1-token blocks (inputs from
    # their own generator, so the cases above keep theirs)
    gen_split = torch.Generator(device="cuda").manual_seed(14)

    def rand_split(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen_split, device="cuda").to(
            dtype)

    cases += [
        ("48-token blocks, chunks inside blocks bf16",
         rand_split((16, 1, d)), rand_split((25, 4, 48, d)),
         rand_split((25, 4, 48, d)), None, None, tables_for(25, 4, 6),
         lens([5, 101, 250, 287])),
        ("1-token blocks, q_len=2 bf16", rand_split((8, 2, d)),
         rand_split((600, 2, 1, d)), rand_split((600, 2, 1, d)), None, None,
         tables_for(600, 4, 140), lens([0, 1, 77, 140])),
    ]
    worst = 0.0
    for name, q, kp, vp, ksc, vsc, tables, lengths in cases:
        scale = q.shape[-1] ** -0.5
        out_k, lse_k = kern.paged_decode_attention(q, kp, vp, tables,
                                                   lengths, ksc, vsc, scale)
        same_bits(torch, f"paged_decode_attention {name}", (out_k, lse_k),
                  kern.paged_decode_attention(q, kp, vp, tables, lengths,
                                              ksc, vsc, scale))
        out_p, lse_p = fa._paged_decode_plain(q, kp, vp, tables, lengths,
                                              ksc, vsc, scale)
        torch.cuda.synchronize()
        tol = tol_for(torch, q.dtype)
        err, share = close(torch, [(out_k, out_p)], tol)
        check(share <= 1, f"paged_decode_attention {name}: out err "
                          f"{err:.3g}, {share:.3g} x the limit {tol}")
        lerr = compare_lse(torch, lse_k, lse_p, TOL_LSE,
                           f"paged_decode_attention {name}")
        empty = (lengths == 0).repeat_interleave(q.shape[0] // len(lengths))
        check(bool((out_k[empty] == 0).all())
              and bool((lse_k[empty] == float("-inf")).all()),
              "paged_decode_attention: empty rows are not 0 / -inf")
        splits = kern.decode_splits(q.shape[0], tables.shape[1] *
                                    kp.shape[2], q.shape[1])
        print(f"paged_decode_attention {name}: max_abs_err out {err:.3g}, "
              f"{share:.3g} x the limit {tol}; lse {lerr:.3g} "
              f"(tol {TOL_LSE}); {splits} chunks a slot-head; a second "
              "launch equal bit for bit")
        if q.shape[1] == 1 and kp.dtype == torch.bfloat16:
            worst = max(worst, err)

    # poison: NaN in every block no cursor covers, and every table entry
    # past ceil(len / bs) naming no block at all: not a bit may change
    _, q, kp, vp, _, _, tables, lengths = path
    scale = d ** -0.5
    clean = kern.paged_decode_attention(q, kp, vp, tables, lengths, None,
                                        None, scale)
    live = (torch.arange(n_table, device="cuda")[None, :] * bs
            < lengths[:, None])
    covered = torch.zeros(nb, dtype=torch.bool, device="cuda")
    covered[tables[live].long()] = True
    kn, vn = kp.clone(), vp.clone()
    kn[~covered] = float("nan")
    vn[~covered] = float("nan")
    garbage = torch.where(live, tables, torch.full_like(tables, 1 << 30))
    poisoned = kern.paged_decode_attention(q, kn, vn, garbage, lengths, None,
                                           None, scale)
    torch.cuda.synchronize()
    check(torch.equal(poisoned[0], clean[0])
          and torch.equal(poisoned[1], clean[1]),
          "paged_decode_attention: output changed when unread blocks hold "
          "NaN and unread table entries name no block")
    print(f"paged_decode_attention poison: {int((~covered).sum())} uncovered "
          f"blocks NaN, {int((~live).sum())} table entries past the cursors "
          f"2**30: output and lse equal bit for bit")
    del kn, vn, cases

    t = paged_timings(torch, fa, kern, card, path_tables)
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "apex_tpu_torch/csrc/paged_decode_attention.cu",
            "replaces": REPLACES["paged_decode_attention"],
            "max_abs_err": worst, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None}


def paged_timings(torch, fa, kern, card: str, tables) -> dict:
    """``paged_decode_attention`` (bf16, d 64, 128-token blocks through
    ``tables``, 8 per slot) timed beside its plain twin, the dense
    ``decode_attention`` at the same cursors and the bound: every one of 8
    slots x 12 heads at the full 1024 positions (the keys ``ms``,
    ``plain_ms``, ``bound_ms``, ``bound_by``), at :data:`SERVE_CURSORS`,
    and one slot at the full prefix. No PyTorch call reads a block table,
    so there is no library time. Takes the ``_kernels`` and
    ``ops.flash_attention`` modules, so another tree's kernels can be
    timed on the same inputs."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    S, H, d = 8, 12, 64
    bs, nb = PAGED["block_size"], PAGED["num_blocks"]
    T = tables.shape[1] * bs
    q, kp, vp = (torch.randn(shape, generator=gen, device="cuda")
                 .to(torch.bfloat16)
                 for shape in ((S * H, 1, d), (nb, H, bs, d), (nb, H, bs, d)))
    kd, vd = (torch.randn((S * H, T, d), generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(2))
    scale = d ** -0.5

    def lens(values):
        return torch.tensor(values, dtype=torch.int32, device="cuda")

    out = {}
    for what, slots, lengths in (
            ("8 slots x 1024", S, lens([T] * S)),
            (f"8 slots at the serving cursors {SERVE_CURSORS}", S,
             lens(SERVE_CURSORS)),
            ("one slot x 1024", 1, lens([T]))):
        n = slots * H
        args = (q[:n], kp, vp, tables[:slots], lengths, None, None, scale)
        lengths_bh = lengths.repeat_interleave(H)
        ms = device_ms(torch, lambda: kern.paged_decode_attention(*args))
        plain_ms = device_ms(torch, lambda: fa._paged_decode_plain(*args))
        dense_ms = device_ms(torch, lambda: kern.decode_attention(
            q[:n], kd[:n], vd[:n], lengths_bh, None, None, scale))
        live = int(lengths.sum()) * H       # (position, head) rows read
        entries = int((-(-lengths // bs)).sum())   # live table entries
        nbytes = (2 * live * d * 2 + nbytes_of(q[:n], q[:n], lengths)
                  + n * 4 + entries * 4)
        b_ms, b_by = bound(nbytes, 2 * 2 * live * d)
        splits = kern.decode_splits(n, T, 1)
        print(f"paged_decode_attention timing, {what} (128-token blocks): "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library none "
              f"(no PyTorch call reads a block table); dense "
              f"decode_attention at the same cursors {dense_ms:.4f} ms; "
              f"bound {b_ms:.5f} ms ({b_by}; {nbytes / 1e6:.3f} MB); "
              f"{splits} chunks a slot-head, both kernels [{card}]")
        out.setdefault("ms", ms)
        out.setdefault("plain_ms", plain_ms)
        out.setdefault("bound_ms", b_ms)
        out.setdefault("bound_by", b_by)
    return out


# the decode kernels' head-dim phase: every d they take (a multiple of 8
# from 8 to 256); int8 at one d of each lane-group width (csrc/decode.cuh:
# the lanes a row needs, rounded up to a power of two), fp32 past 128,
# where a lane takes two 16-byte slices; dims they refuse
DECODE_DIMS = tuple(range(8, 257, 8))
DECODE_DIMS_INT8 = (8, 16, 24, 40, 96, 200)
DECODE_DIMS_FP32 = (136, 256)
DECODE_DIMS_OUT = (4, 12, 264)


def check_head_dims(torch, fa, cache_mod, kern) -> None:
    """Both decode kernels against their plain versions at every head dim
    they take, at one small shape each (2 slots x 2 heads, 96 positions,
    16-token blocks for the paged one; one slot empty: out 0, lse -inf):
    bf16 q over a bf16 cache at q_len 1 and 3, bf16 q over int8 at
    :data:`DECODE_DIMS_INT8`, fp32 over fp32 at q_len 2 at
    :data:`DECODE_DIMS_FP32`; :data:`DECODE_DIMS_OUT` must raise
    ``NotImplementedError``. Prints the worst share of the limit per
    kernel."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    S, H, bs, n_table = 2, 2, 16, 6
    T, n = n_table * bs, S * H
    nb = 2 * S * n_table + 1
    lengths = torch.tensor([0, 77], dtype=torch.int32, device="cuda")
    lengths_bh = lengths.repeat_interleave(H)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(6))
    tables = (perm[: S * n_table] + 1).view(S, n_table).to(
        device="cuda", dtype=torch.int32)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    runs = [(d, q_len, torch.bfloat16, torch.bfloat16)
            for d in DECODE_DIMS for q_len in (1, 3)]
    runs += [(d, 1, torch.bfloat16, torch.int8) for d in DECODE_DIMS_INT8]
    runs += [(d, 2, torch.float32, torch.float32) for d in DECODE_DIMS_FP32]
    worst = {"decode_attention": 0.0, "paged_decode_attention": 0.0}
    for d, q_len, qdt, kvdt in runs:
        q = rand((n, q_len, d), qdt)
        scale = d ** -0.5
        cache_dt = torch.float32 if kvdt == torch.int8 else kvdt
        kd, vd = rand((n, T, d), cache_dt), rand((n, T, d), cache_dt)
        kp, vp = (rand((nb, H, bs, d), cache_dt) for _ in range(2))
        dense_sc = paged_sc = (None, None)
        if kvdt == torch.int8:
            (kd, ksd), (vd, vsd) = (cache_mod._quantize(x) for x in (kd, vd))
            (kp, ksp), (vp, vsp) = (cache_mod._quantize(x) for x in (kp, vp))
            dense_sc, paged_sc = (ksd, vsd), (ksp, vsp)
        for name, launch, plain in (
                ("decode_attention",
                 lambda: kern.decode_attention(q, kd, vd, lengths_bh,
                                               *dense_sc, scale),
                 lambda: fa._decode_plain(q, kd, vd, lengths_bh, *dense_sc,
                                          scale)),
                ("paged_decode_attention",
                 lambda: kern.paged_decode_attention(q, kp, vp, tables,
                                                     lengths, *paged_sc,
                                                     scale),
                 lambda: fa._paged_decode_plain(q, kp, vp, tables, lengths,
                                                *paged_sc, scale))):
            what = (f"{name} d {d}, q_len {q_len}, {str(qdt)[6:]} q over "
                    f"{str(kvdt)[6:]}")
            out_k, lse_k = launch()
            out_p, lse_p = plain()
            torch.cuda.synchronize()
            tol = tol_for(torch, qdt)
            err, share = close(torch, [(out_k, out_p)], tol)
            check(share <= 1, f"{what}: out err {err:.3g}, {share:.3g} x "
                              f"the limit {tol}")
            compare_lse(torch, lse_k, lse_p, TOL_LSE, what)
            check(bool((out_k[:H] == 0).all())
                  and bool((lse_k[:H] == float("-inf")).all()),
                  f"{what}: the empty slot's rows are not 0 / -inf")
            worst[name] = max(worst[name], share)
    for d in DECODE_DIMS_OUT:
        q = rand((n, 1, d), torch.bfloat16)
        kd = rand((n, T, d), torch.bfloat16)
        kp = rand((nb, H, bs, d), torch.bfloat16)
        for name, launch in (
                ("decode_attention", lambda: kern.decode_attention(
                    q, kd, kd, lengths_bh, None, None, 1.0)),
                ("paged_decode_attention",
                 lambda: kern.paged_decode_attention(
                     q, kp, kp, tables, lengths, None, None, 1.0))):
            try:
                launch()
            except NotImplementedError:
                continue
            fail(f"{name} took head dim {d}")
    print(f"decode head dims: {len(runs)} runs of each kernel over d "
          f"{DECODE_DIMS[0]}..{DECODE_DIMS[-1]} step 8 (bf16 q over bf16 at "
          f"q_len 1 and 3, over int8 at d {DECODE_DIMS_INT8}, fp32 at d "
          f"{DECODE_DIMS_FP32}, an empty slot in each), worst share of the "
          f"limit: decode_attention {worst['decode_attention']:.3g}, "
          f"paged_decode_attention {worst['paged_decode_attention']:.3g}; "
          f"d {DECODE_DIMS_OUT} raise NotImplementedError")


FLASH_DIMS = tuple(range(8, 257, 8))
FLASH_DIMS_OUT = (4, 12, 264)
# the head-dim check's shape: (batch, heads, seq) and the folded dbias's
# bias (2, 2, 1, 96) with dropout, bf16 inputs
FLASH_DIMS_SHAPE = (2, 2, 96)
FLASH_DIMS_DROPOUT = 0.1
# the head-dim timings: GPT's attention shape at the head dims of the
# reference's models (16: examples/gpt_serve.py; 64: GPT-2; 80: GPT-3 2.7B,
# Pythia-2.8B, Phi-2; 96, 128, 256)
FLASH_TIMING_DIMS = (16, 64, 80, 96, 128, 256)
FLASH_HEAD_DIMS = ("d % 8 == 0, 8 to 256, each at the body width "
                   "_kernels.flash_width(d): d rounded up to 16, or to 32 "
                   "past 128")


def check_flash_head_dims(torch, fa, kern, card: str) -> None:
    """``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv``, the dbias
    folded into ``flash_bwd_dkv`` and ``flash_dbias`` against their plain
    versions at every head dim they take (:data:`FLASH_DIMS`), each at its
    body width: 4 batch-heads x 96 x 96, causal, in bf16 and fp32, then in
    bf16 with a ``(2, 2, 1, 96)`` bias and dropout 0.1 with the fold, and
    in fp32 with a ``(1, 2, 96, 96)`` table and dropout 0.1 with
    ``flash_dbias``. Each launch is repeated and must give the same bits;
    :data:`FLASH_DIMS_OUT` must raise ``NotImplementedError`` in all three
    kernels. Prints the worst share of the limit per kernel."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, h, s = FLASH_DIMS_SHAPE
    n = b * h

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "fold": 0.0, "flash_dbias": 0.0}

    def twice(what, launch):
        first = launch()
        first = first if isinstance(first, tuple) else (first,)
        again = launch()
        same_bits(torch, what, first, again if isinstance(again, tuple)
                  else (again,))
        return first

    runs = 0
    for d in FLASH_DIMS:
        scale = d ** -0.5
        cases = [(torch.bfloat16, None, 0.0), (torch.float32, None, 0.0),
                 (torch.bfloat16, rand((b, h, 1, s), torch.float32),
                  FLASH_DIMS_DROPOUT),
                 (torch.float32, rand((1, h, s, s), torch.float32),
                  FLASH_DIMS_DROPOUT)]
        for dt, bias, rate in cases:
            what = (f"d {d} (width {kern.flash_width(d)}) {str(dt)[6:]}"
                    + (f", {tuple(bias.shape)} bias and dropout"
                       if bias is not None else ""))
            seed = 1313 if rate else None
            q, k, v, do = (rand((n, s, d), dt) for _ in range(4))
            tol = tol_for(torch, dt)
            out_k, lse_k = twice(f"flash_fwd {what}", lambda: kern.flash_fwd(
                q, k, v, True, scale, rate, seed, bias=bias))
            out_p, lse_p = fa._flash_fwd_plain(q, k, v, True, scale, rate,
                                               seed, bias=bias)
            torch.cuda.synchronize()
            errs = {"flash_fwd": close(torch, [(out_k, out_p)], tol,
                                       fwd_slack(torch, fa, q, k, v, True,
                                                 scale, rate, seed, bias))}
            compare_lse(torch, lse_k, lse_p, TOL_LSE, f"flash_fwd {what}")
            delta = (do.float() * out_p.float()).sum(dim=-1)
            args = (q, k, v, do, lse_p, delta, True, scale, rate, seed)
            (dq_k,) = twice(f"flash_bwd_dq {what}",
                            lambda: kern.flash_bwd_dq(*args, bias=bias))
            dk_k, dv_k = twice(f"flash_bwd_dkv {what}",
                               lambda: kern.flash_bwd_dkv(*args, bias=bias))
            dq_p = fa._flash_bwd_dq_plain(*args, bias=bias)
            dk_p, dv_p = fa._flash_bwd_dkv_plain(*args, bias=bias)
            torch.cuda.synchronize()
            errs["flash_bwd_dq"] = close(torch, [(dq_k, dq_p)], tol)
            errs["flash_bwd_dkv"] = close(torch, [(dk_k, dk_p), (dv_k, dv_p)],
                                          tol)
            if bias is not None and kern.dbias_folds(bias.shape, dt):
                # check_fold_case repeats the folded launch and holds its
                # dK/dV to the unfolded launch's bit for bit
                errs["fold"] = check_fold_case(torch, fa, kern, what, args,
                                               bias, None)
            elif bias is not None:
                errs["flash_dbias"] = check_dbias_case(torch, fa, kern, what,
                                                       args, bias, None)
            for kname, (err, share) in errs.items():
                check(share <= 1, f"{kname} {what}: err {err:.3g}, "
                                  f"{share:.3g} x the limit")
                worst[kname] = max(worst[kname], share)
            runs += 1
    for d in FLASH_DIMS_OUT:
        q = rand((n, s, d), torch.bfloat16)
        lse = torch.zeros((n, s), device="cuda")
        for kname, launch in (
                ("flash_fwd", lambda: kern.flash_fwd(q, q, q, True, 1.0)),
                ("flash_bwd_dq", lambda: kern.flash_bwd_dq(
                    q, q, q, q, lse, lse, True, 1.0)),
                ("flash_bwd_dkv", lambda: kern.flash_bwd_dkv(
                    q, q, q, q, lse, lse, True, 1.0))):
            try:
                launch()
            except NotImplementedError:
                continue
            fail(f"{kname} took head dim {d}")
    print(f"flash head dims: {runs} runs of flash_fwd, flash_bwd_dq and "
          f"flash_bwd_dkv over d {FLASH_DIMS[0]}..{FLASH_DIMS[-1]} step 8 "
          f"({n} batch-heads x {s} x {s}, causal; bf16, fp32, bf16 with a "
          f"({b}, {h}, 1, {s}) bias, dropout {FLASH_DIMS_DROPOUT} and the "
          f"folded dbias, fp32 with a (1, {h}, {s}, {s}) table, dropout "
          f"{FLASH_DIMS_DROPOUT} and flash_dbias), each launch repeated bit "
          f"for bit, worst share of "
          f"the limit: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + f"; d {FLASH_DIMS_OUT} raise NotImplementedError [{card}]")


def flash_dim_timings(torch, fa, kern, card: str) -> dict:
    """``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv`` at GPT's
    attention shape (96 x 1024 x 1024, causal, bf16) at each head dim of
    :data:`FLASH_TIMING_DIMS`: device ms beside the bound of the true d's
    bytes and operations, and the body width. No d may be slower than a
    larger one in any of the three kernels. Returns ``{kernel: {d: ms}}``."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    n, sq, sk, _ = TRAIN_ATTN
    times = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    pairs = n * (sq * (sq + 1) // 2)   # visible (row, col) pairs, causal
    row_bytes = n * sq * 4
    for d in FLASH_TIMING_DIMS:
        q, k, v, do = (torch.randn((n, sq, d), generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        scale = d ** -0.5
        out, lse = kern.flash_fwd(q, k, v, True, scale)
        delta = (do.float() * out.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta, True, scale)
        tile = nbytes_of(q)
        work = {"flash_fwd": (4 * tile + row_bytes, 2 * 2 * pairs * d),
                "flash_bwd_dq": (5 * tile + 2 * row_bytes, 3 * 2 * pairs * d),
                "flash_bwd_dkv": (6 * tile + 2 * row_bytes,
                                  4 * 2 * pairs * d)}
        calls = {"flash_fwd": lambda: kern.flash_fwd(q, k, v, True, scale),
                 "flash_bwd_dq": lambda: kern.flash_bwd_dq(*args),
                 "flash_bwd_dkv": lambda: kern.flash_bwd_dkv(*args)}
        shown = []
        for kname, fn in calls.items():
            ms = device_ms(torch, fn, iters=20)
            times[kname][d] = ms
            b_ms, b_by = bound(*work[kname])
            shown.append(f"{kname} {ms:.4f} ms (bound {b_ms:.4f} ms, "
                         f"{b_by})")
        print(f"flash head dim {d} (body width {kern.flash_width(d)}), "
              f"{n} x {sq} x {sk} causal bf16: " + ", ".join(shown)
              + f" [{card}]")
        del q, k, v, do, out, lse, delta, args
    for kname, by_d in times.items():
        for i, d in enumerate(FLASH_TIMING_DIMS):
            for wider in FLASH_TIMING_DIMS[i + 1:]:
                check(by_d[d] <= by_d[wider],
                      f"{kname}: head dim {d} ({by_d[d]:.4f} ms) is slower "
                      f"than head dim {wider} ({by_d[wider]:.4f} ms)")
    print("flash head-dim timings: no head dim slower than a larger one in "
          "flash_fwd, flash_bwd_dq or flash_bwd_dkv")
    return times


def check_flash_train(torch, fa, kern, card: str):
    """flash_fwd with dropout, flash_bwd_dq and flash_bwd_dkv against their
    plain versions: the training shape and the edge cases; the dropout
    mask read back from the kernel bit for bit; timing at the training
    shape. Returns the rows of the three kernels."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    # the mask itself: with q = k = 0 every visible probability is 1 / sk,
    # and v = I (sk = d) puts entry (row, col) of the dropped probabilities
    # in out[row, col], so out > 0 iff the kernel kept (row, col)
    n, sq, d = 8, 256, 64
    zeros = torch.zeros((n, sq, d), device="cuda")
    eye = torch.eye(d, device="cuda").expand(n, d, d).contiguous()
    for seed in (1234, -7):
        out, _ = kern.flash_fwd(zeros, zeros[:, :d].contiguous(), eye,
                                False, 1.0, TRAIN_DROPOUT, seed)
        keep = fa._keep_mask(seed, n, sq, d, TRAIN_DROPOUT, "cuda")
        check(bool(((out > 0) == keep).all()),
              f"flash_fwd dropout mask differs from dropout_keep_mask "
              f"(seed {seed})")
    print(f"flash_fwd  dropout mask (rate {TRAIN_DROPOUT}, seeds 1234, -7, "
          f"8x256x64): equal to dropout_keep_mask bit for bit")

    cases = [  # (name, n, sq, sk, d, causal, dtype, rate)
        ("training path (8x12, 1024, 1024, d64) causal bf16",
         *TRAIN_ATTN, True, torch.bfloat16, 0.0),
        ("training shape, dropout 0.1, causal bf16",
         *TRAIN_ATTN, True, torch.bfloat16, TRAIN_DROPOUT),
        ("ragged sq=sk=100 causal bf16", 6, 100, 100, 64, True,
         torch.bfloat16, 0.0),
        ("cross sq=64 < sk=200 causal bf16", 6, 64, 200, 64, True,
         torch.bfloat16, 0.0),
        ("cross sq=64 < sk=200 non-causal bf16", 6, 64, 200, 64, False,
         torch.bfloat16, 0.0),
        ("ragged sq=sk=100 causal fp32, dropout 0.1", 6, 100, 100, 64, True,
         torch.float32, TRAIN_DROPOUT),
        ("fp32 d128 causal, dropout 0.1", 4, 128, 128, 128, True,
         torch.float32, TRAIN_DROPOUT),
        ("fp32 d128 non-causal sq=96 < sk=160", 4, 96, 160, 128, False,
         torch.float32, 0.0),
        ("fully masked rows sq=96 > sk=40 causal fp32", 4, 96, 40, 64, True,
         torch.float32, 0.0),
    ]
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for name, n, sq, sk, d, causal, dt, rate in cases:
        q, k, v = (rand((n, s, d), dt) for s in (sq, sk, sk))
        do = rand((n, sq, d), dt)
        scale = d ** -0.5
        seed = 20240 if rate else None
        tol = tol_for(torch, dt)
        out_k, lse_k = kern.flash_fwd(q, k, v, causal, scale, rate, seed)
        out_p, lse_p = fa._flash_fwd_plain(q, k, v, causal, scale, rate,
                                           seed)
        torch.cuda.synchronize()
        errs = {"flash_fwd": close(torch, [(out_k, out_p)], tol, fwd_slack(
            torch, fa, q, k, v, causal, scale, rate, seed))}
        compare_lse(torch, lse_k, lse_p, TOL_LSE, f"flash_fwd {name}")
        # the backward pair on identical inputs: the plain forward's
        # output and lse
        delta = (do.float() * out_p.float()).sum(dim=-1)
        args = (q, k, v, do, lse_p, delta, causal, scale, rate, seed)
        dq_k = kern.flash_bwd_dq(*args)
        dk_k, dv_k = kern.flash_bwd_dkv(*args)
        dq_p = fa._flash_bwd_dq_plain(*args)
        dk_p, dv_p = fa._flash_bwd_dkv_plain(*args)
        torch.cuda.synchronize()
        errs["flash_bwd_dq"] = close(torch, [(dq_k, dq_p)], tol)
        errs["flash_bwd_dkv"] = close(torch, [(dk_k, dk_p), (dv_k, dv_p)],
                                      tol)
        for kname, (err, share) in errs.items():
            check(share <= 1, f"{kname} {name}: err {err:.3g}, {share:.3g} "
                              f"x the limit {tol}")
        if sq > sk and causal:
            masked = sq - sk
            check(bool((out_k[:, :masked] == 0).all())
                  and bool(torch.isinf(lse_k[:, :masked]).all())
                  and bool((dq_k[:, :masked] == 0).all()),
                  "fully masked rows: out, lse or dq not 0 / +inf / 0")
        print(f"flash train {name}: max_abs_err, share of the limit "
              f"{tol}: " + ", ".join(
                  f"{kname[6:]} {err:.3g}, {share:.3g}"
                  for kname, (err, share) in errs.items()))
        if (n, sq, sk, d) == TRAIN_ATTN:
            for kname, (err, _) in errs.items():
                worst[kname] = max(worst[kname], err)
        del q, k, v, do, out_k, out_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p

    # timing at the training shape, bf16 causal, no dropout (the bench
    # step's path)
    n, sq, sk, d = TRAIN_ATTN
    q, k, v, do = (rand((n, s, d), torch.bfloat16) for s in (sq, sk, sk, sq))
    scale = d ** -0.5
    out, lse = kern.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * out.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, True, scale)
    same_bits(torch, "flash_fwd at the training shape", (out, lse),
              kern.flash_fwd(q, k, v, True, scale))
    same_bits(torch, "flash_bwd_dkv at the training shape",
              kern.flash_bwd_dkv(*args), kern.flash_bwd_dkv(*args))
    dq_once = kern.flash_bwd_dq(*args)
    same_bits(torch, "flash_bwd_dq at the training shape", (dq_once,),
              (kern.flash_bwd_dq(*args),))
    print("flash_fwd, flash_bwd_dq and flash_bwd_dkv at the training shape: "
          "a second launch equal bit for bit")
    retaken(torch, kern, "GPT's shape (96 x 1024 x 1024, d64, causal)",
            args, {}, n * (sq * (sq + 1) // 2), dq_once)
    del dq_once
    kernel = {"flash_fwd": lambda: kern.flash_fwd(q, k, v, True, scale),
              "flash_bwd_dq": lambda: kern.flash_bwd_dq(*args),
              "flash_bwd_dkv": lambda: kern.flash_bwd_dkv(*args)}
    plain_fn = {"flash_fwd": lambda: fa._flash_fwd_plain(q, k, v, True,
                                                         scale),
                "flash_bwd_dq": lambda: fa._flash_bwd_dq_plain(*args),
                "flash_bwd_dkv": lambda: fa._flash_bwd_dkv_plain(*args)}
    ms = {name: device_ms(torch, fn, iters=20) for name, fn in kernel.items()}
    plain = {name: device_ms(torch, fn, iters=5)
             for name, fn in plain_fn.items()}
    b, h = TRAIN_BH
    q4, k4, v4, do4 = (t.view(b, h, -1, d) for t in (q, k, v, do))
    lib_fwd = device_ms(torch, lambda: torch.nn.functional
                        .scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=True))
    # one SDPA backward (dQ, dK and dV together) on the same tensors
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, is_causal=True)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do4, retain_graph=True),
        show="SDPA backward")
    del qg, kg, vg, sdpa_out
    library = {"flash_fwd": lib_fwd, "flash_bwd_dq": lib_bwd,
               "flash_bwd_dkv": lib_bwd}
    pairs = n * (sq * (sq + 1) // 2)   # visible (row, col) pairs, causal
    row_bytes = n * sq * 4             # one fp32 value per row
    tile = nbytes_of(q)
    work = {  # bytes (each input read once, each output written once), ops
        "flash_fwd": (4 * tile + row_bytes, 2 * 2 * pairs * d),
        "flash_bwd_dq": (5 * tile + 2 * row_bytes, 3 * 2 * pairs * d),
        "flash_bwd_dkv": (6 * tile + 2 * row_bytes, 4 * 2 * pairs * d)}
    rows = []
    for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        b_ms, b_by = bound(*work[kname])
        print(f"{kname} training-shape timing (96 x 1024 x 1024, d64, causal"
              f" bf16): kernel {ms[kname]:.4f} ms, plain {plain[kname]:.4f} "
              f"ms, SDPA {'fwd' if kname == 'flash_fwd' else 'bwd (dq+dk+dv)'}"
              f" {library[kname]:.4f} ms, bound {b_ms:.5f} ms ({b_by}; "
              f"{work[kname][0] / 1e6:.1f} MB, {work[kname][1] / 1e9:.2f} "
              f"GFLOP) [{card}]")
        rows.append({"name": kname, "route": "cuda",
                     "source": ("apex_tpu_torch/csrc/flash_fwd.cu"
                                if kname == "flash_fwd" else
                                "apex_tpu_torch/csrc/flash_bwd.cu"),
                     "replaces": REPLACES[kname], "max_abs_err": worst[kname],
                     "ms": ms[kname], "plain_ms": plain[kname],
                     "bound_ms": b_ms, "bound_by": b_by,
                     "library_ms": library[kname]})
    return rows


def check_layer_norm(torch, ln, kern, card: str):
    """``ln_fwd`` and ``ln_bwd`` against their plain twins, element by
    element: at the path shape (8192 x 768) in bf16 with bf16 affine
    parameters (GPT's and BERT's case), fp32, mixed (bf16 x, fp32
    parameters, fp32 out), RMSNorm and no affine; and at one wide row,
    1024 x 16384 (one block per row); and at ``LN_EDGE_WIDTHS``, the widths
    just past each template's reach, in bf16 and fp32 (dweight/dbias within
    their limits at 1001 rows). A second ``ln_bwd`` must repeat the
    first bit for bit. Timing at the path shape beside the bound and the
    library calls. Returns the rows of the two kernels."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    f32, bf16 = torch.float32, torch.bfloat16

    def rand(shape, dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift).to(dtype)

    n, h = LN_PATH
    cases = [  # (name, n, h, x dtype, w dtype or None, has bias, rms, out)
        ("path (8192 x 768) bf16, bf16 affine", n, h, bf16, bf16, True,
         False, bf16),
        ("8192 x 768 fp32", n, h, f32, f32, True, False, f32),
        ("mixed: bf16 x, fp32 affine, fp32 out", n, h, bf16, f32, True,
         False, f32),
        ("RMSNorm bf16, bf16 weight", n, h, bf16, bf16, False, True, bf16),
        ("no affine bf16", n, h, bf16, None, False, False, bf16),
        ("wide rows 1024 x 16384 bf16, bf16 affine", *LN_WIDE, bf16, bf16,
         True, False, bf16),
        ("wide rows 1024 x 16384 fp32 RMSNorm", *LN_WIDE, f32, f32, False,
         True, f32),
    ]
    for width in LN_EDGE_WIDTHS:
        cases += [(f"edge {LN_EDGE_ROWS} x {width} bf16, bf16 affine",
                   LN_EDGE_ROWS, width, bf16, bf16, True, False, bf16),
                  (f"edge {LN_EDGE_ROWS} x {width} fp32", LN_EDGE_ROWS, width,
                   f32, f32, True, False, f32)]
    worst = {"ln_fwd": 0.0, "ln_bwd": 0.0}
    for name, rows, width, xdt, wdt, has_b, rms, odt in cases:
        x = rand((rows, width), xdt, 2.0, 0.5)
        w = rand((width,), wdt) if wdt is not None else None
        b = rand((width,), wdt) if has_b else None
        out_k, mean_k, inv_k = kern.ln_fwd(x, w, b, LN_EPS, rms, odt)
        out_p, mean_p, inv_p = ln._ln_fwd_plain(x, w, b, LN_EPS, rms, odt)
        torch.cuda.synchronize()
        tol = tol_for(torch, odt)
        err_f, share = close(torch, [(out_k, out_p)], tol)
        check(share <= 1, f"ln_fwd {name}: out err {err_f:.3g}, {share:.3g}"
                          f" x the limit {tol}")
        s_err, s_share = close(torch, [(mean_k, mean_p), (inv_k, inv_p)],
                               FP32_TOL)
        check(s_share <= 1, f"ln_fwd {name}: mean/invvar err {s_err:.3g}, "
                            f"{s_share:.3g} x the limit {FP32_TOL}")
        # the backward on identical inputs: the plain forward's statistics
        dy = rand((rows, width), odt)
        args = (dy, x, mean_p, inv_p, w, rms, has_b)
        dx_k, dw_k, db_k = kern.ln_bwd(*args)
        again = kern.ln_bwd(*args)
        dx_p, dw_p, db_p = ln._ln_bwd_plain(*args)
        torch.cuda.synchronize()
        check(all((a is None and c is None) or torch.equal(a, c)
                  for a, c in zip((dx_k, dw_k, db_k), again)),
              f"ln_bwd {name}: a second launch differs")
        err_x, share_x = close(torch, [(dx_k, dx_p)], tol_for(torch, xdt))
        pairs = [(g, r) for g, r in ((dw_k, dw_p), (db_k, db_p))
                 if r is not None]
        err_w, share_w = 0.0, 0.0
        if pairs:
            err_w, share_w = close(torch, pairs, (
                LN_PARAM_GRAD_TOL if wdt == f32 else BF16_TOL))
        check(share_x <= 1 and share_w <= 1,
              f"ln_bwd {name}: dx err {err_x:.3g} ({share_x:.3g} x the "
              f"limit), dweight/dbias err {err_w:.3g} ({share_w:.3g} x)")
        print(f"layer_norm {name}: max_abs_err, share of the limit: fwd out "
              f"{err_f:.3g}, {share:.3g}; stats {s_err:.3g}; bwd dx "
              f"{err_x:.3g}, {share_x:.3g}; dweight/dbias {err_w:.3g}, "
              f"{share_w:.3g}; a second ln_bwd equal bit for bit")
        if (rows, width, xdt, rms) == (n, h, bf16, False) and wdt == bf16:
            worst["ln_fwd"] = err_f
            worst["ln_bwd"] = max(err_x, err_w)
        del x, dy, out_k, out_p, dx_k, dx_p, again

    # timing at the path shape: bf16 x, bf16 affine, bf16 out. Each call
    # takes the next of LN_COPIES sets of rows (75 MB and more in all, over
    # the 50 MB L2), so it reads them from device memory, as a training
    # step's LayerNorm finds its input after the layer's other passes
    w, b, rms_w = rand((h,), bf16), rand((h,), bf16), rand((h,), bf16)
    sets = []
    for _ in range(LN_COPIES):
        x = rand((n, h), bf16, 2.0, 0.5)
        _, mean, inv = kern.ln_fwd(x, w, b, LN_EPS, False, bf16)
        _, lmean, lrstd = torch.ops.aten.native_layer_norm(x, [h], w, b,
                                                           LN_EPS)
        sets.append((x, rand((n, h), bf16), mean, inv, lmean, lrstd))

    def rotating(fn):
        turn = [0]

        def call():
            turn[0] += 1
            return fn(*sets[turn[0] % LN_COPIES])
        return call

    fwd = {"kernel": lambda x, *_: kern.ln_fwd(x, w, b, LN_EPS, False,
                                               bf16),
           "plain": lambda x, *_: ln._ln_fwd_plain(x, w, b, LN_EPS, False,
                                                   bf16),
           "library": lambda x, *_: torch.nn.functional.layer_norm(
               x, (h,), w, b, LN_EPS)}
    bwd = {"kernel": lambda x, dy, mean, inv, *_: kern.ln_bwd(
               dy, x, mean, inv, w, False, True),
           "plain": lambda x, dy, mean, inv, *_: ln._ln_bwd_plain(
               dy, x, mean, inv, w, False, True),
           "library": lambda x, dy, _m, _i, lmean, lrstd:
               torch.ops.aten.native_layer_norm_backward(
                   dy, x, [h], lmean, lrstd, w, b, [True, True, True])}
    rms = {"kernel": lambda x, *_: kern.ln_fwd(x, rms_w, None, LN_EPS, True,
                                               bf16),
           "plain": lambda x, *_: ln._ln_fwd_plain(x, rms_w, None, LN_EPS,
                                                   True, bf16),
           "library": lambda x, *_: torch.nn.functional.rms_norm(
               x, (h,), rms_w, LN_EPS)}
    times = {kname: {k: device_ms(torch, rotating(fn), iters=4 * LN_COPIES,
                                  show=f"{kname} {k}" if k == "kernel"
                                  else "")
                     for k, fn in fns.items()}
             for kname, fns in (("ln_fwd", fwd), ("ln_bwd", bwd),
                                ("rms", rms))}
    rms_times = times.pop("rms")
    x, dy = sets[0][:2]
    stats = 2 * n * 4                      # mean and invvar, fp32
    work = {  # bytes (inputs read once, outputs written once), operations
        "ln_fwd": (nbytes_of(x, w, b, x) + stats, 8 * n * h),
        "ln_bwd": (nbytes_of(dy, x, x, w, w, b) + stats, 12 * n * h)}
    rows = []
    library = {"ln_fwd": "F.layer_norm",
               "ln_bwd": "aten.native_layer_norm_backward"}
    for kname, src in (("ln_fwd", "normalization/_pallas.py:116"),
                       ("ln_bwd", "normalization/_pallas.py:129")):
        b_ms, b_by = bound(*work[kname])
        t = times[kname]
        grid = ""
        if kname == "ln_bwd":
            # ln_bwd's grid: its scratch's two partial rows an SM, which
            # csrc/layer_norm.cu cuts to one wave where fewer blocks fit
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            grid = (f"; grid {kern.ln_bwd_ctas(n, h, 2 * sms)} blocks (two "
                    f"an SM, fewer only where the occupancy query finds "
                    f"fewer resident)")
        print(f"{kname} path timing (8192 x 768, bf16, bf16 affine, inputs "
              f"not in L2): kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, library "
              f"{t['library']:.4f} ms ({library[kname]}), bound "
              f"{b_ms:.5f} ms ({b_by}; {work[kname][0] / 1e6:.1f} MB)"
              f"{grid} [{card}]")
        rows.append({"name": kname, "route": "cuda",
                     "source": "apex_tpu_torch/csrc/layer_norm.cu",
                     "replaces": f"apex_tpu/{src}",
                     "max_abs_err": worst[kname], "ms": t["kernel"],
                     "plain_ms": t["plain"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": t["library"]})
    print(f"ln_fwd RMSNorm path timing (8192 x 768 bf16, bf16 weight): "
          f"kernel {rms_times['kernel']:.4f} ms, plain "
          f"{rms_times['plain']:.4f} ms, F.rms_norm "
          f"{rms_times['library']:.4f} ms [{card}]")
    return rows


def check_flash_bias(torch, fa, kern, card: str) -> None:
    """The three flash kernels with a score bias against their plain
    versions, under the limits of the unbiased checks: BERT's shape (16 x
    12 heads, 512, d 64, non-causal, bf16) with its ``(16, 1, 1, 512)``
    padding bias and with a ``(1, 12, 512, 512)`` bias, then causal,
    dropout, fp32 and full-shape cases; timing at BERT's shape with the
    padding bias beside SDPA with the same float mask."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    cpu_gen = torch.Generator().manual_seed(6)
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def padding(b, s):
        lengths = torch.randint(s // 2, s + 1, (b,), generator=cpu_gen)
        keep = torch.arange(s)[None, :] < lengths[:, None]
        return torch.where(keep, 0.0, -10000.0)[:, None, None, :].to(
            "cuda")

    (b, h), (n, s, _, d) = BERT_BH, BERT_ATTN
    cases = [  # (name, b, h, sq, sk, d, causal, dtype, rate, bias)
        ("BERT path (16x12, 512, d64) padding bias non-causal bf16", b, h,
         s, s, d, False, bf16, 0.0, padding(b, s)),
        ("BERT shape, (1, 12, 512, 512) bias non-causal bf16", b, h, s, s,
         d, False, bf16, 0.0, rand((1, h, s, s))),
        ("padding bias causal, dropout 0.1 bf16", 4, 12, 256, 256, 64, True,
         bf16, TRAIN_DROPOUT, padding(4, 256)),
        ("(b, h, sq, sk) bias cross sq=64 < sk=200 causal fp32", 2, 3, 64,
         200, 64, True, f32, 0.0, rand((2, 3, 64, 200))),
        ("(b, 1, sq, sk) bias fp32 d128, dropout 0.1", 2, 2, 96, 160, 128,
         False, f32, TRAIN_DROPOUT, rand((2, 1, 96, 160))),
    ]
    for name, bb, hh, sq, sk, dd, causal, dt, rate, bias in cases:
        nn_ = bb * hh
        q, k, v = (rand((nn_, t, dd), dt) for t in (sq, sk, sk))
        do = rand((nn_, sq, dd), dt)
        scale = dd ** -0.5
        seed = 777 if rate else None
        tol = tol_for(torch, dt)
        out_k, lse_k = kern.flash_fwd(q, k, v, causal, scale, rate, seed,
                                      bias=bias)
        out_p, lse_p = fa._flash_fwd_plain(q, k, v, causal, scale, rate,
                                           seed, bias=bias)
        torch.cuda.synchronize()
        errs = {"flash_fwd": close(torch, [(out_k, out_p)], tol, fwd_slack(
            torch, fa, q, k, v, causal, scale, rate, seed, bias))}
        compare_lse(torch, lse_k, lse_p, TOL_LSE, f"flash_fwd {name}")
        check(bool(torch.isfinite(lse_k).all()),
              f"flash_fwd {name}: a biased row took lse +inf")
        delta = (do.float() * out_p.float()).sum(dim=-1)
        args = (q, k, v, do, lse_p, delta, causal, scale, rate, seed)
        dq_k = kern.flash_bwd_dq(*args, bias=bias)
        dk_k, dv_k = kern.flash_bwd_dkv(*args, bias=bias)
        dq_p = fa._flash_bwd_dq_plain(*args, bias=bias)
        dk_p, dv_p = fa._flash_bwd_dkv_plain(*args, bias=bias)
        torch.cuda.synchronize()
        errs["flash_bwd_dq"] = close(torch, [(dq_k, dq_p)], tol)
        errs["flash_bwd_dkv"] = close(torch, [(dk_k, dk_p), (dv_k, dv_p)],
                                      tol)
        for kname, (err, share) in errs.items():
            check(share <= 1, f"{kname} {name}: err {err:.3g}, {share:.3g} "
                              f"x the limit {tol}")
        print(f"flash bias {name}: max_abs_err, share of the limit {tol}: "
              + ", ".join(f"{kname[6:]} {err:.3g}, {share:.3g}"
                          for kname, (err, share) in errs.items()))
        del q, k, v, do, out_k, out_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p

    # timing at BERT's shape with its padding bias
    bias = padding(b, s)
    q, k, v, do = (rand((n, s, d), bf16) for _ in range(4))
    scale = d ** -0.5
    out, lse = kern.flash_fwd(q, k, v, False, scale, bias=bias)
    delta = (do.float() * out.float()).sum(dim=-1)
    args = (q, k, v, do, lse, delta, False, scale)
    retaken(torch, kern, "BERT's shape (192 x 512 x 512, d64, padding bias)",
            args, dict(bias=bias), n * s * s,
            kern.flash_bwd_dq(*args, bias=bias))
    kernel = {"flash_fwd": lambda: kern.flash_fwd(q, k, v, False, scale,
                                                  bias=bias),
              "flash_bwd_dq": lambda: kern.flash_bwd_dq(*args, bias=bias),
              "flash_bwd_dkv": lambda: kern.flash_bwd_dkv(*args, bias=bias)}
    plain_fn = {"flash_fwd": lambda: fa._flash_fwd_plain(q, k, v, False,
                                                         scale, bias=bias),
                "flash_bwd_dq": lambda: fa._flash_bwd_dq_plain(*args,
                                                               bias=bias),
                "flash_bwd_dkv": lambda: fa._flash_bwd_dkv_plain(
                    *args, bias=bias)}
    ms = {name: device_ms(torch, fn, iters=10) for name, fn in kernel.items()}
    plain = {name: device_ms(torch, fn, iters=5)
             for name, fn in plain_fn.items()}
    q4, k4, v4, do4 = (t.view(b, h, s, d) for t in (q, k, v, do))
    mask = bias.to(bf16)
    lib_fwd = device_ms(torch, lambda: torch.nn.functional
                        .scaled_dot_product_attention(q4, k4, v4,
                                                      attn_mask=mask),
                        show="SDPA forward with a float mask")
    qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
    sdpa_out = torch.nn.functional.scaled_dot_product_attention(
        qg, kg, vg, attn_mask=mask)
    lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
        sdpa_out, (qg, kg, vg), do4, retain_graph=True),
        show="SDPA backward with a float mask")
    del qg, kg, vg, sdpa_out
    pairs = n * s * s                  # every (row, col) pair is visible
    tile, row_bytes = nbytes_of(q), n * s * 4
    work = {"flash_fwd": (4 * tile + row_bytes + nbytes_of(bias),
                          2 * 2 * pairs * d),
            "flash_bwd_dq": (5 * tile + 2 * row_bytes + nbytes_of(bias),
                             3 * 2 * pairs * d),
            "flash_bwd_dkv": (6 * tile + 2 * row_bytes + nbytes_of(bias),
                              4 * 2 * pairs * d)}
    for kname in kernel:
        b_ms, b_by = bound(*work[kname])
        lib = lib_fwd if kname == "flash_fwd" else lib_bwd
        print(f"{kname} BERT-shape timing with the padding bias (192 x 512 x "
              f"512, d64, non-causal bf16): kernel {ms[kname]:.4f} ms, plain "
              f"{plain[kname]:.4f} ms, SDPA with a float attn_mask "
              f"{'fwd' if kname == 'flash_fwd' else 'bwd (dq+dk+dv)'} "
              f"{lib:.4f} ms, bound {b_ms:.5f} ms ({b_by}; "
              f"{work[kname][1] / 1e9:.2f} GFLOP) [{card}]")


# ---------------------------------------------------------------------------
# phase 3 (cont.): segment ids in the flash kernels, and the dbias kernel
# ---------------------------------------------------------------------------

def packed_ids(torch, rng, b: int, s: int, docs: int):
    """``(b, s)`` int32 segment ids on the card: ``docs - 1`` cut points a
    row drawn from ``rng`` in ``1..s-1``, the id counted up at each cut
    (``examples/long_context.py:42-48``, row by row)."""
    import numpy as np
    ids = np.zeros((b, s), np.int32)
    for row in range(b):
        for cut in rng.choice(np.arange(1, s), docs - 1, replace=False):
            ids[row, cut:] += 1
    return torch.from_numpy(ids).to("cuda")


def visible_pairs(torch, q_ids, kv_ids, causal: bool, heads: int) -> int:
    """The (row, col) scores the ids (and the causal mask) leave visible,
    over every batch-head: the pairs a bound counts."""
    sq, sk = q_ids.shape[1], kv_ids.shape[1]
    row = torch.arange(sq, device=q_ids.device)[:, None]
    col = torch.arange(sk, device=q_ids.device)[None, :]
    total = 0
    for b in range(q_ids.shape[0]):
        seen = q_ids[b][:, None] == kv_ids[b][None, :]
        if causal:
            seen &= col <= row + (sk - sq)
        total += int(seen.sum())
    return total * heads


def check_flash_segments(torch, fa, kern, card: str) -> None:
    """The three flash kernels with segment ids against their plain
    versions, under the limits of the other flash checks: self-attention
    ids (four documents a row), ``(q_ids, kv_ids)`` pairs at sq < sk with a
    query id no key carries (its rows must give out 0, lse +inf and dq 0),
    ids with a ``(16, 1, 1, 512)`` padding bias, causal, dropout 0.1; d 32,
    64 and 128 in bf16 and fp32. Then ``examples/long_context.py``'s packed
    call at its defaults through ``flash_attention``, on the kernels and
    with ``use_kernel=False``."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(7)
    cpu_gen = torch.Generator().manual_seed(7)
    rng = np.random.RandomState(7)
    bf16, f32 = torch.bfloat16, torch.float32

    def rand(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def padding(b, s):
        lengths = torch.randint(s // 2, s + 1, (b,), generator=cpu_gen)
        keep = torch.arange(s)[None, :] < lengths[:, None]
        return torch.where(keep, 0.0, -10000.0)[:, None, None, :].to(
            "cuda")

    cases = [  # (name, b, h, sq, sk, d, causal, dtype, rate, pair, bias)
        ("self ids (4 x 12, 512, d64) causal bf16", 4, 12, 512, 512, 64,
         True, bf16, 0.0, False, False),
        ("self ids (2 x 8, 256, d32) causal fp32", 2, 8, 256, 256, 32, True,
         f32, 0.0, False, False),
        ("self ids (2 x 4, 200, d128) non-causal bf16", 2, 4, 200, 200, 128,
         False, bf16, 0.0, False, False),
        ("pair sq=96 < sk=200, an absent query id, causal fp32 d64", 2, 3,
         96, 200, 64, True, f32, 0.0, True, False),
        ("pair sq=96 < sk=200, an absent query id, non-causal bf16 d32", 2,
         3, 96, 200, 32, False, bf16, 0.0, True, False),
        ("ids + (16, 1, 1, 512) padding bias, causal, dropout 0.1 bf16", 16,
         2, 512, 512, 64, True, bf16, TRAIN_DROPOUT, False, True),
        ("ids + padding bias, causal, dropout 0.1 fp32 d128", 4, 2, 256, 256,
         128, True, f32, TRAIN_DROPOUT, False, True),
    ]
    for name, b, h, sq, sk, d, causal, dt, rate, pair, biased in cases:
        n = b * h
        q, k, v = (rand((n, t, d), dt) for t in (sq, sk, sk))
        do = rand((n, sq, d), dt)
        kv_ids = packed_ids(torch, rng, b, sk, 4)
        q_ids = packed_ids(torch, rng, b, sq, 4) if pair else kv_ids
        masked = 0
        if pair:
            masked = 9
            q_ids[-1, :masked] = 77        # no key carries id 77
        segs = (q_ids, kv_ids)
        bias = padding(b, sk) if biased else None
        scale = d ** -0.5
        seed = 31 if rate else None
        tol = tol_for(torch, dt)
        kw = dict(bias=bias, segments=segs)
        out_k, lse_k = kern.flash_fwd(q, k, v, causal, scale, rate, seed,
                                      **kw)
        out_p, lse_p = fa._flash_fwd_plain(q, k, v, causal, scale, rate,
                                           seed, **kw)
        torch.cuda.synchronize()
        errs = {"flash_fwd": close(torch, [(out_k, out_p)], tol, fwd_slack(
            torch, fa, q, k, v, causal, scale, rate, seed, bias))}
        compare_lse(torch, lse_k, lse_p, TOL_LSE, f"flash_fwd {name}")
        delta = (do.float() * out_p.float()).sum(dim=-1)
        args = (q, k, v, do, lse_p, delta, causal, scale, rate, seed)
        dq_k = kern.flash_bwd_dq(*args, **kw)
        dk_k, dv_k = kern.flash_bwd_dkv(*args, **kw)
        dq_p = fa._flash_bwd_dq_plain(*args, **kw)
        dk_p, dv_p = fa._flash_bwd_dkv_plain(*args, **kw)
        torch.cuda.synchronize()
        errs["flash_bwd_dq"] = close(torch, [(dq_k, dq_p)], tol)
        errs["flash_bwd_dkv"] = close(torch, [(dk_k, dk_p), (dv_k, dv_p)],
                                      tol)
        for kname, (err, share) in errs.items():
            check(share <= 1, f"{kname} {name}: err {err:.3g}, {share:.3g} "
                              f"x the limit {tol}")
        if masked:
            rows = slice((b - 1) * h, n)
            check(bool((out_k[rows, :masked] == 0).all())
                  and bool(torch.isinf(lse_k[rows, :masked]).all())
                  and bool((lse_k[rows, :masked] > 0).all())
                  and bool((dq_k[rows, :masked] == 0).all()),
                  f"{name}: rows of an absent id: out, lse or dq not 0 / "
                  "+inf / 0")
        print(f"flash segments {name}: max_abs_err, share of the limit "
              f"{tol}: " + ", ".join(
                  f"{kname[6:]} {err:.3g}, {share:.3g}"
                  for kname, (err, share) in errs.items())
              + (f"; {masked} rows of an absent id 0 / +inf / 0"
                 if masked else ""))
        del q, k, v, do, out_k, out_p, dq_k, dk_k, dv_k, dq_p, dk_p, dv_p

    # examples/long_context.py's packed call at its defaults (one device:
    # 256 positions, 8 heads, d 32, fp32, causal, four documents)
    rng = np.random.RandomState(0)
    s, heads, d = 256, 8, 32
    q, k, v = (torch.from_numpy(rng.randn(1, heads, s, d)).to(
        "cuda", f32) for _ in range(3))
    bounds = sorted(rng.choice(np.arange(1, s), 3, replace=False))
    ids = np.zeros((1, s), np.int32)
    for cut in bounds:
        ids[0, cut:] += 1
    ids = torch.from_numpy(ids).to("cuda")
    before = kern.LAUNCHES["flash_fwd"]
    packed = fa.flash_attention(q, k, v, causal=True, segment_ids=ids)
    check(kern.LAUNCHES["flash_fwd"] == before + 1,
          "the packed example's call did not launch flash_fwd")
    plain = fa.flash_attention(q, k, v, causal=True, segment_ids=ids,
                               use_kernel=False)
    torch.cuda.synchronize()
    err, share = close(torch, [(packed, plain)], FP32_TOL)
    check(share <= 1, f"packed example: err {err:.3g}, {share:.3g} x the "
                      f"limit {FP32_TOL}")
    print(f"packed-varlen over {s} tokens / 4 docs (examples/"
          f"long_context.py's call, cuts {[int(c) for c in bounds]}): "
          f"{float((packed ** 2).sum()):.6f} on the kernels, "
          f"{float((plain ** 2).sum()):.6f} plain; max_abs_err {err:.3g}, "
          f"{share:.3g} x the limit {FP32_TOL} [{card}]")


def check_flash_dq(torch, fa, kern, card: str) -> None:
    """``flash_bwd_dq``'s bf16 tensor-core body against its plain twin at d
    32, 64 and 128 beyond the cases of the checks above (which hold it at d
    64 on the training, BERT, segment-id and long-context inputs): causal,
    cross (sq < sk), ragged, fully masked rows (which must give dq 0), a
    padding bias, a per-head bias, segment ids and dropout 0.1, under the
    bf16 limits; each launch repeated bit for bit."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(10)
    cpu_gen = torch.Generator().manual_seed(10)
    rng = np.random.RandomState(10)
    bf16 = torch.bfloat16

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    def padding(b, s):
        lengths = torch.randint(s // 2, s + 1, (b,), generator=cpu_gen)
        keep = torch.arange(s)[None, :] < lengths[:, None]
        return torch.where(keep, 0.0, -10000.0)[:, None, None, :].to(
            "cuda")

    cases = [  # (name, b, h, sq, sk, d, causal, rate, bias, ids)
        ("d32 causal", 2, 6, 256, 256, 32, True, 0.0, None, False),
        ("d128 causal", 2, 6, 256, 256, 128, True, 0.0, None, False),
        ("d128 cross sq=64 < sk=200 causal", 1, 6, 64, 200, 128, True, 0.0,
         None, False),
        ("d32 cross sq=64 < sk=200 non-causal", 1, 6, 64, 200, 32, False,
         0.0, None, False),
        ("d128 ragged sq=sk=100 causal", 1, 6, 100, 100, 128, True, 0.0,
         None, False),
        ("d32 ragged sq=sk=100 causal, dropout 0.1", 1, 6, 100, 100, 32,
         True, TRAIN_DROPOUT, None, False),
        ("d64 fully masked rows sq=96 > sk=40 causal", 1, 4, 96, 40, 64,
         True, 0.0, None, False),
        ("d128 fully masked rows sq=96 > sk=40 causal", 1, 4, 96, 40, 128,
         True, 0.0, None, False),
        ("d128 dropout 0.1 causal", 2, 4, 256, 256, 128, True,
         TRAIN_DROPOUT, None, False),
        ("d128 (4, 1, 1, 256) padding bias non-causal", 4, 4, 256, 256, 128,
         False, 0.0, "padding", False),
        ("d32 (1, 4, 192, 192) per-head bias causal", 2, 4, 192, 192, 32,
         True, 0.0, "head", False),
        ("d32 segment ids causal", 4, 4, 320, 320, 32, True, 0.0, None,
         True),
        ("d128 segment ids + per-head bias, dropout 0.1, causal", 2, 4, 256,
         256, 128, True, TRAIN_DROPOUT, "head", True),
    ]
    for name, b, h, sq, sk, d, causal, rate, bias_kind, with_ids in cases:
        n = b * h
        q, k, v, do = (rand((n, t, d), bf16) for t in (sq, sk, sk, sq))
        bias = (padding(b, sk) if bias_kind == "padding" else
                rand((1, h, sq, sk)) if bias_kind == "head" else None)
        segs = None
        if with_ids:
            ids = packed_ids(torch, rng, b, sk, 4)
            segs = (ids, ids)
        scale = d ** -0.5
        seed = 99 if rate else None
        kw = dict(bias=bias, segments=segs)
        out_p, lse_p = fa._flash_fwd_plain(q, k, v, causal, scale, rate, seed,
                                           **kw)
        delta = (do.float() * out_p.float()).sum(dim=-1)
        args = (q, k, v, do, lse_p, delta, causal, scale, rate, seed)
        dq_k = kern.flash_bwd_dq(*args, **kw)
        same_bits(torch, f"flash_bwd_dq {name}", (dq_k,),
                  (kern.flash_bwd_dq(*args, **kw),))
        dq_p = fa._flash_bwd_dq_plain(*args, **kw)
        torch.cuda.synchronize()
        err, share = close(torch, [(dq_k, dq_p)], BF16_TOL)
        check(share <= 1, f"flash_bwd_dq {name}: err {err:.3g}, {share:.3g} "
                          f"x the limit {BF16_TOL}")
        note = ""
        if causal and sq > sk:
            masked = sq - sk
            check(bool(torch.isinf(lse_p[:, :masked]).all())
                  and bool((dq_k[:, :masked] == 0).all()),
                  f"flash_bwd_dq {name}: fully masked rows' dq not 0")
            note = f"; {masked} fully masked rows 0"
        print(f"flash_bwd_dq bf16 {name} ({n} x {sq} x {sk}): max_abs_err "
              f"{err:.3g}, {share:.3g} x the limit {BF16_TOL}; a second "
              f"launch equal bit for bit{note} [{card}]")
        del q, k, v, do, out_p, dq_k, dq_p


def check_dbias_case(torch, fa, kern, name: str, args, bias, segs) -> tuple:
    """``flash_dbias`` against ``_flash_dbias_plain`` on ``args`` (the
    inputs of ``flash_bwd_dq``), a second launch equal bit for bit; returns
    (max abs error, share of the limit)."""
    db_k = kern.flash_dbias(*args, bias=bias, segments=segs)
    again = kern.flash_dbias(*args, bias=bias, segments=segs)
    db_p = fa._flash_dbias_plain(*args, bias=bias, segments=segs)
    torch.cuda.synchronize()
    check(torch.equal(db_k, again), f"flash_dbias {name}: a second launch "
                                    "differs")
    return dbias_close(torch, db_k, db_p, name)


def check_fold_case(torch, fa, kern, name: str, args, bias, segs,
                    want=None) -> tuple:
    """The dbias folded into ``flash_bwd_dkv`` (``need_dbias=True``)
    against ``want``, the plain dbias (``_flash_dbias_plain`` on ``args``
    when not given), under ``DBIAS_TOL``; a second folded launch equal bit
    for bit, and its dK and dV equal to the unfolded launch's bit for bit.
    Returns (max abs error, share of the limit)."""
    kw = dict(bias=bias, segments=segs)
    folded = kern.flash_bwd_dkv(*args, **kw, need_dbias=True)
    same_bits(torch, f"flash_bwd_dkv with the folded dbias {name}", folded,
              kern.flash_bwd_dkv(*args, **kw, need_dbias=True))
    unfolded = kern.flash_bwd_dkv(*args, **kw)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(folded, unfolded)),
          f"flash_bwd_dkv {name}: the folded launch's dK/dV differ from the "
          "unfolded launch's")
    del unfolded
    if want is None:
        want = fa._flash_dbias_plain(*args, **kw)
    return dbias_close(torch, folded[2], want, f"fold {name}")


def dbias_close(torch, got, want, name: str) -> tuple:
    """(max abs error, share of the limit) of a dbias under ``DBIAS_TOL``,
    its atol scaled by the plain output's largest value."""
    atol, rtol, rel = DBIAS_TOL
    err, share = close(torch, [(got, want)],
                       (atol * float(want.abs().max()), rtol, rel))
    check(share <= 1, f"flash_dbias {name}: err {err:.3g}, {share:.3g} x "
                      "the limit")
    return err, share


def check_flash_dbias(torch, fa, kern, card: str) -> None:
    """``flash_dbias`` against its plain twin at the six bias shapes of
    ``DBIAS_SHAPES`` (the five of ``tests/test_flash_attention.py:133-139``
    and ``(b, 1, 1, sk)``), scaled to ``(2, 12, 512, 512)``: non-causal
    bf16; causal with dropout 0.3 and segment ids in fp32 and in bf16; and
    ragged (sq 500 < sk 510) causal bf16 at d 32. Each launch repeated,
    equal bit for bit. Where the fold takes the bias (``dbias_folds``: bf16,
    the two row shapes), the folded dbias too (``check_fold_case``)."""
    import numpy as np
    gen = torch.Generator(device="cuda").manual_seed(8)
    rng = np.random.RandomState(8)
    bf16, f32 = torch.bfloat16, torch.float32
    b, h, s = DBIAS_BH_S

    def rand(shape, dtype=f32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    variants = [  # (name, sq, sk, d, causal, dtype, rate, ids)
        ("non-causal bf16", s, s, 64, False, bf16, 0.0, False),
        ("causal, dropout 0.3, segment ids, fp32", s, s, 64, True, f32, 0.3,
         True),
        ("ragged sq=500 < sk=510 causal bf16 d32", 500, 510, 32, True, bf16,
         0.0, False),
        ("causal, dropout 0.3, segment ids, bf16", s, s, 64, True, bf16, 0.3,
         True),
    ]
    for vname, sq, sk, d, causal, dt, rate, with_ids in variants:
        n = b * h
        q, k, v = (rand((n, t, d), dt) for t in (sq, sk, sk))
        do = rand((n, sq, d), dt)
        segs = None
        if with_ids:
            ids = packed_ids(torch, rng, b, sq, 4)
            segs = (ids, ids)
        scale, seed = d ** -0.5, (99 if rate else None)
        readings, folds = [], []
        for full in DBIAS_SHAPES:
            bias = rand(tuple(dim if f else 1 for dim, f in
                              zip((b, h, sq), full)) + (sk,))
            out, lse = fa._flash_fwd_plain(q, k, v, causal, scale, rate, seed,
                                           bias=bias, segments=segs)
            delta = (do.float() * out.float()).sum(dim=-1)
            args = (q, k, v, do, lse, delta, causal, scale, rate, seed)
            what = f"{tuple(bias.shape)} {vname}"
            err, share = check_dbias_case(torch, fa, kern, what, args, bias,
                                          segs)
            readings.append(f"{tuple(bias.shape)} {err:.3g}, {share:.3g}")
            if kern.dbias_folds(bias.shape, dt):
                err, share = check_fold_case(torch, fa, kern, what, args,
                                             bias, segs)
                folds.append(f"{tuple(bias.shape)} {err:.3g}, {share:.3g}")
        print(f"flash_dbias {vname} (2 x 12 heads): max_abs_err, share of "
              f"the limit {DBIAS_TOL} (atol x max |plain|), a second launch "
              f"equal bit for bit: " + "; ".join(readings) + f" [{card}]")
        if folds:
            print(f"flash_dbias folded into flash_bwd_dkv, {vname}: "
                  f"max_abs_err, share of the limit: " + "; ".join(folds)
                  + "; a second folded launch equal bit for bit, its dK/dV "
                  f"equal to the unfolded launch's [{card}]")
        del q, k, v, do


# ---------------------------------------------------------------------------
# phase 4: GPT-small serving
# ---------------------------------------------------------------------------

def serve(torch, kern, card: str):
    import numpy as np
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving import Request, ServingEngine, SlotScheduler

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_attention_heads=12, max_position_embeddings=1024)
    model = GPTModel(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))

    def engine(m):
        return ServingEngine(m, max_seqs=8, max_len=1024, prefill_len=128,
                             cache_dtype=torch.bfloat16, rng_seed=0,
                             device="cuda")

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    requests = [Request(prompt=p, max_new_tokens=NEW_TOKENS,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i, p in enumerate(prompts)]
    eng = engine(model)
    sched = SlotScheduler(eng)
    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    done = sched.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    L = cfg.num_layers
    check(len(done) == len(requests), f"{len(done)} of {len(requests)} "
                                      "requests completed")
    for c in done.values():
        check(len(c.tokens) == NEW_TOKENS and c.finish_reason == "length",
              f"request {c.request_id}: {len(c.tokens)} tokens, "
              f"{c.finish_reason}")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"request {c.request_id}: token outside the vocab")
    check(launches["flash_fwd"] == L * len(requests),
          f"flash_fwd launches {launches['flash_fwd']} != {L} x "
          f"{len(requests)} prefills")
    check(launches["decode_attention"] == L * sched.steps,
          f"decode_attention launches {launches['decode_attention']} != "
          f"{L} x {sched.steps} decode steps")
    check(launches["paged_decode_attention"] == 0,
          "the dense engine launched paged_decode_attention")
    passes = len(requests) + sched.steps
    check(launches["ln_fwd"] == LN_PER_GPT_PASS * passes
          and launches["ln_bwd"] == 0,
          f"ln_fwd/ln_bwd launches {launches['ln_fwd']}/"
          f"{launches['ln_bwd']} != {LN_PER_GPT_PASS} x {passes} passes / 0")
    tokens = sum(len(c.tokens) for c in done.values())
    print(f"serving: {len(done)} requests, {sched.steps} decode steps, "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
          f"launches {launches} [{card}]")

    # step times: a full prefill window, then decode with all 8 slots live
    window = prompts[1]
    prefill_ms = 1e3 * _host_time(torch, lambda: eng.prefill_logits(window,
                                                                    0), 10)
    for slot in range(eng.max_seqs):
        eng.prefill_logits(window, slot)
    toks = np.zeros(eng.max_seqs, np.int64)
    decode_ms = 1e3 * _host_time(torch, lambda: eng.decode_logits(toks), 20)
    print(f"serving: prefill (128 tokens) {prefill_ms:.3f} ms, decode step "
          f"(8 slots) {decode_ms:.3f} ms [{card}]")
    times = {"prefill_ms": prefill_ms, "decode_ms": decode_ms}
    profile_step(torch, "prefill (128 tokens)",
                 lambda: eng.prefill_logits(window, 0), card)
    profile_step(torch, "decode step (8 slots)",
                 lambda: eng.decode_logits(toks), card)

    # teacher-forced: the kernel path vs the plain path on the card
    plain = GPTModel(dataclasses.replace(cfg, use_kernel=False),
                     device="cuda")
    plain.load_state_dict(model.state_dict())
    ek, ep = engine(model), engine(plain)
    worst = 0.0
    for slot in range(ek.max_seqs):
        p = prompts[slot]
        lk, lp = ek.prefill_logits(p, slot), ep.prefill_logits(p, slot)
        check(bool(torch.isfinite(lk).all()) and lk.shape ==
              (cfg.vocab_size,), "prefill logits not finite/shaped")
        worst = max(worst, max_err(torch, lk, lp))
        toks[slot] = int(lk.argmax())
    for _ in range(4):
        lk, lp = ek.decode_logits(toks), ep.decode_logits(toks)
        check(bool(torch.isfinite(lk).all()) and lk.shape ==
              (ek.max_seqs, cfg.vocab_size), "decode logits not finite")
        worst = max(worst, max_err(torch, lk, lp))
        toks = lk.argmax(dim=-1).cpu().numpy()
    check(worst <= TOL_LOGITS, f"teacher-forced logits err {worst:.3g} > "
                               f"{TOL_LOGITS}")
    print(f"serving: teacher-forced logits kernel vs plain, prefill + 4 "
          f"decode steps: max_abs_err {worst:.4g} (tol {TOL_LOGITS})")
    return launches, times


def serve_paged(torch, kern, card: str, dense_times: dict):
    """GPT-small served by a ``PagedServingEngine`` at the JAX bench's
    ``gpt_decode_paged`` configuration (see the module docstring): launch
    counts, prefix hits and copies on write under the scheduler, then step
    times beside the dense engine's and teacher-forced logits. Returns the
    launch counts of the scheduler run."""
    import numpy as np
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.observability import MetricsRegistry
    from apex_tpu_torch.serving import (PagedServingEngine, Request,
                                        ServingEngine, SlotScheduler)

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_attention_heads=12, max_position_embeddings=1024)
    model = GPTModel(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))
    L = cfg.num_layers

    def engine(m):
        return PagedServingEngine(m, cache_dtype=torch.bfloat16, rng_seed=0,
                                  device="cuda", **PAGED)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    shared = rng.randint(0, cfg.vocab_size, size=PAGED["prefill_len"]
                         ).tolist()
    requests = [Request(prompt=p, max_new_tokens=NEW_TOKENS,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i, p in enumerate(prompts)]
    requests += [Request(prompt=shared, max_new_tokens=NEW_TOKENS)
                 for _ in range(SHARED_REPEATS)]
    eng = engine(model)
    # count the engine's decode steps, prefix-hit tail steps included
    calls = [0]
    decode_logits = eng.decode_logits

    def counted(*args, **kw):
        calls[0] += 1
        return decode_logits(*args, **kw)

    eng.decode_logits = counted
    reg = MetricsRegistry()
    sched = SlotScheduler(eng, registry=reg)
    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    done = sched.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    del eng.decode_logits
    check(len(done) == len(requests), f"paged: {len(done)} of "
                                      f"{len(requests)} requests completed")
    for c in done.values():
        check(len(c.tokens) == NEW_TOKENS and c.finish_reason == "length",
              f"paged request {c.request_id}: {len(c.tokens)} tokens, "
              f"{c.finish_reason}")
        check(all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"paged request {c.request_id}: token outside the vocab")
    hits = int(reg.counter("serve/prefix_hits").value)
    cows = int(reg.counter("serve/blocks_cow_copied").value)
    cold = len(requests) - hits
    check(launches["paged_decode_attention"] == L * calls[0],
          f"paged_decode_attention launches "
          f"{launches['paged_decode_attention']} != {L} x {calls[0]} "
          "decode steps")
    check(launches["flash_fwd"] == L * cold,
          f"paged: flash_fwd launches {launches['flash_fwd']} != {L} x "
          f"{cold} cold prefills")
    check(launches["decode_attention"] == 0,
          "the paged engine launched decode_attention")
    passes = cold + calls[0]
    check(launches["ln_fwd"] == LN_PER_GPT_PASS * passes
          and launches["ln_bwd"] == 0,
          f"paged: ln_fwd/ln_bwd launches {launches['ln_fwd']}/"
          f"{launches['ln_bwd']} != {LN_PER_GPT_PASS} x {passes} passes / 0")
    check(hits >= SHARED_REPEATS - 1 and cows >= SHARED_REPEATS - 1,
          f"paged: {hits} prefix hits and {cows} copies on write, want >= "
          f"{SHARED_REPEATS - 1} each")
    check(eng.allocator.free_blocks == PAGED["num_blocks"] - 1,
          f"paged: {eng.allocator.free_blocks} blocks free after the run")
    # the shared prompt's greedy streams, hit or cold (the hits decode the
    # last prompt position, the cold prefill computed it in the prefill)
    streams = {tuple(done[len(prompts) + i].tokens)
               for i in range(SHARED_REPEATS)}
    tokens = sum(len(c.tokens) for c in done.values())
    shared_tokens = int(reg.counter("serve/prefix_hit_tokens").value)
    ttft_prefix = reg.histogram("serve/ttft_prefix_ms")
    admit_ms = ttft_prefix.sum / max(1, ttft_prefix.count)
    print(f"paged serving: {len(done)} requests, {sched.steps} scheduler "
          f"decode steps + {calls[0] - sched.steps} prefix-hit tail steps, "
          f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tokens/s; "
          f"{hits} prefix hits ({shared_tokens} shared tokens, admission "
          f"{admit_ms:.3f} ms mean), {cows} copies on write, {len(streams)} "
          f"distinct stream(s) among the {SHARED_REPEATS} repeats; launches "
          f"{launches} [{card}]")

    # step times at the bench's throughput state (a fresh pool, every slot
    # cold-prefilled with its own 128-token prompt, then one decode step),
    # in turns with a dense engine at the same state, since the host's
    # speed drifts between phases
    eng = engine(model)
    den = ServingEngine(model, max_seqs=PAGED["max_seqs"],
                        max_len=PAGED["max_len"],
                        prefill_len=PAGED["prefill_len"],
                        cache_dtype=torch.bfloat16, rng_seed=0, device="cuda")
    # 10 timed turns and a prompt a slot, then the profile's warm-up and up
    # to PROFILE_TRIES windows of 5
    fresh = iter([rng.randint(0, cfg.vocab_size, size=PAGED["prefill_len"]
                              ).tolist()
                  for _ in range(11 + PAGED["max_seqs"] + 5 * PROFILE_TRIES)])

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    eng.prefill_logits(shared, 1)          # registers the shared block
    prefill = {"cold": [], "hit": [], "dense_prefill": []}
    for _ in range(10):
        p = next(fresh)
        prefill["cold"].append(timed(lambda: eng.prefill_logits(p, 0)))
        check(eng.last_admit.prefill, "paged: a distinct prompt hit")
        prefill["hit"].append(timed(lambda: eng.prefill_logits(shared, 2)))
        check(not eng.last_admit.prefill, "paged: the shared prompt missed")
        prefill["dense_prefill"].append(timed(
            lambda: den.prefill_logits(p, 0)))
        eng.release_slot(0)
        eng.release_slot(2)
    eng.release_slot(1)
    for slot in range(eng.max_seqs):
        p = next(fresh)
        eng.prefill_logits(p, slot)
        den.prefill_logits(p, slot)
    toks = np.zeros(eng.max_seqs, np.int64)
    eng.decode_logits(toks)
    den.decode_logits(toks)
    decode = {"paged": [], "dense_decode": []}
    for rep in range(4):                   # paged, dense, dense, paged, ...
        for what in (("paged", "dense_decode") if rep % 2 == 0 else
                     ("dense_decode", "paged")):
            e = eng if what == "paged" else den
            decode[what].append(1e3 * _host_time(
                torch, lambda: e.decode_logits(toks), 5))
    med = {k: float(np.median(v)) for k, v in {**prefill, **decode}.items()}
    print(f"paged serving, in turns with a dense engine at the same state: "
          f"prefill (128 tokens) cold {med['cold']:.3f} ms, prefix hit (127 "
          f"shared, 1 decoded with copy on write) {med['hit']:.3f} ms, dense "
          f"{med['dense_prefill']:.3f} ms (medians of 10); decode step (8 "
          f"slots) paged {med['paged']:.3f} ms, dense "
          f"{med['dense_decode']:.3f} ms "
          f"(medians of 4 means of 5); the dense phase read prefill "
          f"{dense_times['prefill_ms']:.3f} ms, decode step "
          f"{dense_times['decode_ms']:.3f} ms [{card}]")
    del den
    profile_step(torch, "paged decode step (8 slots)",
                 lambda: eng.decode_logits(toks), card)

    def release_and_prefill():
        eng.release_slot(0)
        eng.prefill_logits(next(fresh), 0)

    profile_step(torch, "paged release + cold prefill (128 tokens)",
                 release_and_prefill, card)
    del eng

    # teacher-forced: the paged kernel path against the paged plain path
    # and against the dense engine
    plain = GPTModel(dataclasses.replace(cfg, use_kernel=False),
                     device="cuda")
    plain.load_state_dict(model.state_dict())
    ek, ep = engine(model), engine(plain)
    ed = ServingEngine(model, max_seqs=PAGED["max_seqs"],
                       max_len=PAGED["max_len"],
                       prefill_len=PAGED["prefill_len"],
                       cache_dtype=torch.bfloat16, rng_seed=0, device="cuda")
    worst = {"plain": 0.0, "dense": 0.0}
    for slot in range(ek.max_seqs):
        p = prompts[slot]
        lk = ek.prefill_logits(p, slot)
        check(bool(torch.isfinite(lk).all()) and lk.shape ==
              (cfg.vocab_size,), "paged prefill logits not finite/shaped")
        for what, other in (("plain", ep), ("dense", ed)):
            worst[what] = max(worst[what],
                              max_err(torch, lk, other.prefill_logits(p,
                                                                      slot)))
        toks[slot] = int(lk.argmax())
    for _ in range(4):
        lk = ek.decode_logits(toks)
        check(bool(torch.isfinite(lk).all()) and lk.shape ==
              (ek.max_seqs, cfg.vocab_size), "paged decode logits not finite")
        for what, other in (("plain", ep), ("dense", ed)):
            worst[what] = max(worst[what],
                              max_err(torch, lk, other.decode_logits(toks)))
        toks = lk.argmax(dim=-1).cpu().numpy()
    for what, err in worst.items():
        check(err <= TOL_LOGITS, f"paged teacher-forced logits vs {what} "
                                 f"{err:.3g} > {TOL_LOGITS}")
    print(f"paged serving: teacher-forced logits, prefill + 4 decode steps: "
          f"kernel vs plain path max_abs_err {worst['plain']:.4g}, vs the "
          f"dense engine {worst['dense']:.4g} (tol {TOL_LOGITS})")
    return launches


# ---------------------------------------------------------------------------
# speculative serving: the dense and paged verify legs
# ---------------------------------------------------------------------------

# the JAX bench's BENCH_DECODE_CONFIGS["gpt_decode_spec"] (bench.py:953) and
# bench_gpt_decode_spec's workload (bench.py:1285): 8 requests whose
# 128-token prompts are windows of one 8-token pattern repeated, 48 greedy
# new tokens each, n-gram drafting
SPEC = dict(max_seqs=4, max_len=1024, prefill_len=128)
SPEC_K = 4
SPEC_NEW_TOKENS = 48
SPEC_REQUESTS = 8
# the paged leg: gpt_decode_paged's 128-token blocks, 8 blocks a slot for 4
# slots and the null block; 2 more requests repeat the first prompt (prefix
# hits with copy on write)
SPEC_PAGED = dict(SPEC, block_size=128, num_blocks=4 * 8 + 1)
SPEC_REPEATS = 2


def spec_model(torch, compute_dtype):
    """GPT-small at full width and depth, random weights from seed 0 (the
    same weights at either compute dtype)."""
    from apex_tpu_torch.models import GPTConfig, GPTModel
    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_attention_heads=12, max_position_embeddings=1024,
                    compute_dtype=compute_dtype)
    return GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))


def spec_workload(paged: bool):
    """``bench_gpt_decode_spec``'s pattern (its warm-up prompt) and prompts,
    plus the paged leg's repeats of the first prompt."""
    import numpy as np
    pattern = np.random.RandomState(0).randint(1, 32768, size=8).tolist()
    prompts = [(pattern * 32)[i: i + SPEC["prefill_len"]]
               for i in range(SPEC_REQUESTS)]
    if paged:
        prompts += [prompts[0]] * SPEC_REPEATS
    return pattern, prompts


def spec_engine(torch, model, paged: bool, k: int, cache_dtype):
    from apex_tpu_torch.serving import PagedServingEngine, ServingEngine
    if paged:
        return PagedServingEngine(model, cache_dtype=cache_dtype, rng_seed=0,
                                  speculate_k=k, device="cuda", **SPEC_PAGED)
    return ServingEngine(model, cache_dtype=cache_dtype, rng_seed=0,
                         speculate_k=k, device="cuda", **SPEC)


def spec_leg(torch, kern, eng, k: int, pattern, prompts, paged: bool,
             what: str, card: str) -> dict:
    """One leg of ``bench_gpt_decode_spec``: a warm run, then every prompt
    (``SPEC_NEW_TOKENS`` greedy tokens) through ``SlotScheduler.run`` with
    the launch counts set to 0 just before and read just after. Checks the
    completions and the launch counts; returns the completions' tokens in
    request order, tokens/s, the counts, the ``serve/*`` snapshot and the
    cursors and active masks at each verify step."""
    from apex_tpu_torch.observability import MetricsRegistry
    from apex_tpu_torch.serving import Request, SlotScheduler

    SlotScheduler(eng, registry=MetricsRegistry(), speculate_k=k).run(
        [Request(prompt=pattern, max_new_tokens=2)])
    calls = {"verify": 0, "decode": 0}
    seen = []
    verify, decode_logits = eng.verify, eng.decode_logits

    def counted_verify(tokens, drafts, temps, active, **kw):
        calls["verify"] += 1
        # no host sync in the timed run: a device copy of the dense cursors
        seen.append((eng.allocator.lengths.copy() if paged
                     else eng.cache.lengths.clone(), active.copy()))
        return verify(tokens, drafts, temps, active, **kw)

    def counted_decode(*args, **kw):
        calls["decode"] += 1
        return decode_logits(*args, **kw)

    eng.verify, eng.decode_logits = counted_verify, counted_decode
    reg = MetricsRegistry()
    sched = SlotScheduler(eng, registry=reg, speculate_k=k)
    requests = [Request(prompt=p, max_new_tokens=SPEC_NEW_TOKENS)
                for p in prompts]
    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    done = sched.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    del eng.verify, eng.decode_logits
    snap = reg.snapshot()
    check(len(done) == len(prompts), f"{what}: {len(done)} of {len(prompts)}"
                                     " requests completed")
    for c in done.values():
        check(len(c.tokens) == SPEC_NEW_TOKENS and c.finish_reason == "length",
              f"{what} request {c.request_id}: {len(c.tokens)} tokens, "
              f"{c.finish_reason}")
    L = eng.model.cfg.num_layers
    steps = int(snap["serve/decode_steps"])
    hits = int(snap.get("serve/prefix_hits", 0))
    cold = len(prompts) - hits
    passes = calls["verify"] + calls["decode"]
    kernel, other = (("paged_decode_attention", "decode_attention") if paged
                     else ("decode_attention", "paged_decode_attention"))
    check(launches[kernel] == L * passes,
          f"{what}: {kernel} launches {launches[kernel]} != {L} x {passes} "
          f"steps ({calls['verify']} verify, {calls['decode']} decode)")
    check(launches[other] == 0, f"{what}: launched {other}")
    check(launches["flash_fwd"] == L * cold,
          f"{what}: flash_fwd launches {launches['flash_fwd']} != {L} x "
          f"{cold} cold prefills")
    ln_per_pass = 2 * L + 1        # LN_PER_GPT_PASS at 12 layers
    check(launches["ln_fwd"] == ln_per_pass * (cold + passes)
          and launches["ln_bwd"] == 0,
          f"{what}: ln_fwd/ln_bwd launches {launches['ln_fwd']}/"
          f"{launches['ln_bwd']} != {ln_per_pass} x {cold + passes} "
          "passes / 0")
    if k:
        check(calls["verify"] == steps
              and snap["serve/spec_steps"] == snap["serve/decode_steps"],
              f"{what}: {calls['verify']} verify calls, spec_steps "
              f"{snap['serve/spec_steps']}, decode_steps {steps}")
    else:
        check(calls["verify"] == 0, f"{what}: the plain leg verified")
    tokens = sum(len(c.tokens) for c in done.values())
    tail = calls["decode"] - (0 if k else steps)
    print(f"{what}: {len(done)} requests, {steps} scheduler steps"
          + (f" ({tail} prefix-hit tail steps)" if paged else "")
          + f", {tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} "
          f"tokens/s; {hits} prefix hits, "
          f"{int(snap.get('serve/blocks_cow_copied', 0))} copies on write; "
          "accept rate "
          f"{snap.get('serve/spec_accept_rate', float('nan')):.4f} "
          f"({int(snap.get('serve/spec_accepted', 0))} of "
          f"{int(snap.get('serve/spec_drafted', 0))} drafts); launches "
          f"{launches} [{card}]")
    return {"streams": [done[i].tokens for i in range(len(prompts))],
            "tps": tokens / wall, "launches": launches, "snap": snap,
            "seen": seen, "steps": steps}


def ref_streams(torch, e0, waves):
    """The non-speculative engine's greedy streams, wave by wave (a wave
    fills the slots), with the logits at every position: ``(R, gaps,
    logits)``, ``logits[w] (n, N, vocab)`` whose position t predicts token
    t, ``gaps`` the top-1/top-2 logit gap there."""
    import numpy as np
    S, N = e0.max_seqs, SPEC_NEW_TOKENS
    R, gaps, ref = [], [], []
    for wave in waves:
        n = len(wave)
        active = np.zeros(S, np.bool_)
        active[:n] = True
        steps = [torch.stack([e0.prefill_logits(p, s)
                              for s, p in enumerate(wave)])]
        toks = np.zeros(S, np.int64)
        for _ in range(N - 1):
            toks[:n] = steps[-1].argmax(dim=-1).cpu().numpy()
            steps.append(e0.decode_logits(toks, active)[:n])
        lg = torch.stack(steps, dim=1)
        top2 = lg.topk(2, dim=-1).values
        R += lg.argmax(dim=-1).cpu().numpy().tolist()
        gaps += (top2[..., 0] - top2[..., 1]).cpu().numpy().tolist()
        ref.append(lg)
        for s in range(n):
            e0.release_slot(s)
    return R, gaps, ref


def spec_parity(torch, model, paged: bool, cache_dtype, prompts, legs,
                card: str, what: str) -> float:
    """The speculative engine against the non-speculative one on the card:

    (a) teacher-forced, full acceptance: drafts replay the non-speculative
    greedy stream, so every window is accepted whole; each verify row's
    logits within ``TOL_LOGITS`` of the non-speculative logits at its
    position. A window may stop short only where the reference's top-1/
    top-2 gap is within twice the largest error seen (a near-tie); the
    paged leg's repeats are admitted by the allocator alone (a prefix hit
    with copy on write pending), so their first verify window, from the
    prompt's last position, copies the shared block;
    (b) full rejection: drafts ``(argmax + 1) % vocab``, every count 1 and
    the emitted token the reference's, near-ties excepted;
    (c) streams: the scheduler legs' completions (``legs``: plain and
    speculative) equal to the reference stream token for token up to its
    first near-tie; then each leg teacher-forced over every token
    (:func:`forced_stream`), a token off the reference allowed only at a
    near-tie, after which the leg re-synchronises on the reference.

    Returns the teacher-forced max abs logits error."""
    import numpy as np
    S, k, N = SPEC["max_seqs"], SPEC_K, SPEC_NEW_TOKENS
    vocab = model.cfg.vocab_size
    e0 = spec_engine(torch, model, paged, 0, cache_dtype)
    e1 = spec_engine(torch, model, paged, k, cache_dtype)
    waves = [prompts[i: i + S] for i in range(0, len(prompts), S)]
    R, gaps, ref = ref_streams(torch, e0, waves)
    del e0
    captured = []
    verify_forward = e1.model.verify_forward

    def capture(*args, **kw):
        out = verify_forward(*args, **kw)
        captured.append(out[0])
        return out

    e1.model.verify_forward = capture
    temps = np.zeros(S, np.float32)

    def run_windows(w, e, drafts_for, on_window):
        """Teacher-forced verify steps of wave ``w`` until every slot holds
        N reference tokens: slot s's window is its last reference token in
        the cache's next position and ``drafts_for(r, e)``."""
        wave = waves[w]
        while True:
            act = np.array([s < len(wave) and e[s] < N for s in range(S)])
            if not act.any():
                return
            toks = np.zeros(S, np.int64)
            drafts = np.zeros((S, k), np.int64)
            for s in np.flatnonzero(act):
                r = R[w * S + s]
                toks[s] = r[e[s] - 1] if e[s] else wave[s][-1]
                drafts[s] = drafts_for(r, e[s])
            out, counts = e1.verify(toks, drafts, temps, act)
            lg = captured.pop()
            check(bool((counts[~act] == 0).all())
                  and bool((counts[act] >= 1).all()),
                  f"{what}: counts {counts.tolist()} for active "
                  f"{act.tolist()}")
            for s in map(int, np.flatnonzero(act)):
                on_window(w * S + s, s, int(e[s]), out[s], int(counts[s]),
                          lg[s])
                e[s] += int(counts[s])

    # (a) teacher-forced, full acceptance
    worst = [0.0]
    windows = [0, 0]                     # whole, stopped short
    short = []                           # (request, position)
    cows = e1.allocator.cow_copies if paged else 0

    def replay(r, e):
        d = r[e: e + k]
        return d + [r[-1]] * (k - len(d))

    def tally(req, s, e, out, count, lg):
        r, w = R[req], req // S
        rows = min(k + 1, N - e)
        worst[0] = max(worst[0], max_err(torch, lg[:rows],
                                         ref[w][s, e: e + rows]))
        off = [i for i in range(min(count, N - e)) if int(out[i]) != r[e + i]]
        if off:
            short.append((req, e + off[0]))
        windows[int(bool(off) or count < min(k, N - e) + 1)] += 1

    for w, wave in enumerate(waves):
        e = np.zeros(S, np.int64)
        for s, p in enumerate(wave):
            hit = paged and w * S + s >= SPEC_REQUESTS
            if hit:
                plan = e1.allocator.admit(s, p, e1.prefill_blocks)
                check(not plan.prefill and plan.cow_pending,
                      f"{what}: the repeated prompt was not a prefix hit "
                      "with copy on write pending")
            else:
                lk = e1.prefill_logits(p, s)
                worst[0] = max(worst[0], max_err(torch, lk, ref[w][s, 0]))
                e[s] = 1
        run_windows(w, e, replay, tally)
        for s in range(len(wave)):
            e1.release_slot(s)
    err = worst[0]
    check(err <= TOL_LOGITS, f"{what} (a): verify logits err {err:.3g} > "
                             f"{TOL_LOGITS}")
    near = 2 * err
    for req, pos in short:
        check(gaps[req][pos] <= near,
              f"{what} (a): request {req} left the reference stream at "
              f"token {pos}, where its top-2 gap {gaps[req][pos]:.4g} > "
              f"{near:.4g}")
    if paged:
        check(e1.allocator.cow_copies - cows >= SPEC_REPEATS,
              f"{what} (a): {e1.allocator.cow_copies - cows} copies on "
              "write in the verify windows")
    print(f"{what} (a) teacher-forced: {windows[0]} windows accepted whole, "
          f"{windows[1]} stopped at a near-tie "
          f"{[(q, p, round(gaps[q][p], 5)) for q, p in short]}; verify "
          f"logits max_abs_err {err:.4g} (tol {TOL_LOGITS})"
          + (f"; {e1.allocator.cow_copies - cows} copies on write in the "
             "repeats' first verify windows" if paged else "")
          + f" [{card}]")

    # (b) full rejection
    flips = []

    def reject(r, e):
        return [(t + 1) % vocab for t in replay(r, e)]

    def rejected(req, s, e, out, count, lg):
        check(count == 1, f"{what} (b): request {req} accepted {count - 1} "
                          f"wrong drafts at token {e}")
        if int(out[0]) != R[req][e]:
            flips.append((req, e))

    for w, wave in enumerate(waves):
        e = np.ones(S, np.int64)
        for s, p in enumerate(wave):
            e1.prefill_logits(p, s)
        run_windows(w, e, reject, rejected)
        for s in range(len(wave)):
            e1.release_slot(s)
    for req, pos in flips:
        check(gaps[req][pos] <= near,
              f"{what} (b): request {req} emitted another token at {pos}, "
              f"gap {gaps[req][pos]:.4g} > {near:.4g}")
    print(f"{what} (b) full rejection: every count 1 over "
          f"{len(prompts) * (N - 1)} windows, {len(flips)} emitted tokens "
          f"off the reference, all at near-ties {flips}")
    del e1.model.verify_forward

    # (c) the scheduler legs' streams against the reference up to their
    # first near-tie, then both legs teacher-forced over every token
    compared, ties, same = 0, [], 0
    for req in range(len(prompts)):
        t0 = next((t for t in range(N) if gaps[req][t] <= near), N)
        if t0 < N:
            ties.append((req, t0, round(gaps[req][t0], 5)))
        for leg, streams in legs.items():
            check(streams[req][:t0] == R[req][:t0],
                  f"{what} (c): the {leg} leg's request {req} differs from "
                  f"the reference before its first near-tie ({t0})")
        compared += t0
        plain, spec = legs["plain"][req], legs["speculative"][req]
        same += next((t for t in range(N) if plain[t] != spec[t]), N)
    print(f"{what} (c) streams: plain and speculative completions equal to "
          f"the reference over {compared} of {len(prompts) * N} tokens up "
          f"to the first near-tie (top-2 gap <= {near:.4g}) of "
          f"{len(ties)} requests {ties}; the speculative completions "
          f"follow the plain ones for {same} tokens before any differs")
    checked = {leg: forced_stream(torch, model, paged, cache_dtype, waves,
                                  R, gaps, near, k if leg == "speculative"
                                  else 0, f"{what} (c) {leg}")
               for leg in ("plain", "speculative")}
    for leg, (n, allowed) in checked.items():
        check(n == len(prompts) * N,
              f"{what} (c): the {leg} leg checked {n} of "
              f"{len(prompts) * N} tokens")
    print(f"{what} (c) teacher-forced, re-synchronised after each near-tie: "
          + "; ".join(f"{leg} leg {n} of {len(prompts) * N} tokens checked, "
                      f"{len(allowed)} near-ties where it differed "
                      f"{allowed}" for leg, (n, allowed) in checked.items())
          + f" [{card}]")
    return err


def forced_stream(torch, model, paged: bool, cache_dtype, waves, R, gaps,
                  near: float, k: int, what: str) -> tuple:
    """One leg of check (c), teacher-forced: every token of every request
    compared with the reference stream ``R`` once. The plain leg (``k``
    0) decodes with the reference's last token as input; the speculative
    leg verifies ``NGramDraftSource`` drafts over the reference context. A
    token off the reference must sit at a near-tie (top-2 gap <=
    ``near``); the leg then re-synchronises on the reference's token (the
    speculative leg's cursor rolled back to the last position whose input
    was the reference's). The waves fill the slots in reverse order, so
    every request decodes in another row than the reference's. Returns the
    tokens checked and the near-ties where the leg differed."""
    import numpy as np
    from apex_tpu_torch.serving import NGramDraftSource
    eng = spec_engine(torch, model, paged, k, cache_dtype)
    S, N = SPEC["max_seqs"], SPEC_NEW_TOKENS
    temps = np.zeros(S, np.float32)
    source = NGramDraftSource()
    checked, allowed = 0, []

    def seen(req, pos, tok):
        nonlocal checked
        checked += 1
        if tok == R[req][pos]:
            return True
        check(gaps[req][pos] <= near,
              f"{what}: request {req} token {pos} is {tok}, not the "
              f"reference's {R[req][pos]}, at a top-2 gap "
              f"{gaps[req][pos]:.4g} > {near:.4g}")
        allowed.append((req, pos))
        return False

    for w, wave in enumerate(waves):
        slot_of = {i: S - 1 - i for i in range(len(wave))}
        e = np.zeros(S, np.int64)           # reference tokens consumed
        reqs = {slot_of[i]: w * S + i for i in range(len(wave))}
        for i, p in enumerate(wave):
            seen(reqs[slot_of[i]], 0, eng.prefill(p, slot_of[i]))
            e[slot_of[i]] = 1
        while True:
            act = np.array([s in reqs and e[s] < N for s in range(S)])
            if not act.any():
                break
            toks = np.zeros(S, np.int64)
            for s in np.flatnonzero(act):
                toks[s] = R[reqs[s]][e[s] - 1]
            if not k:
                out = eng.decode(toks, temps, act)
                for s in map(int, np.flatnonzero(act)):
                    seen(reqs[s], int(e[s]), int(out[s]))
                    e[s] += 1
                continue
            drafts = np.zeros((S, k), np.int64)
            for s in np.flatnonzero(act):
                r = reqs[s]
                ctx = list(waves[w][r - w * S]) + R[r][:e[s]]
                drafts[s] = source.draft(ctx, k)
            out, counts = eng.verify(toks, drafts, temps, act)
            for s in map(int, np.flatnonzero(act)):
                r, c = reqs[s], int(counts[s])
                used = c
                for j in range(min(c, N - int(e[s]))):
                    if not seen(r, int(e[s]) + j, int(out[s, j])):
                        used = j + 1
                        break
                e[s] += min(used, N - int(e[s]))
                # the cursor holds the prompt and the consumed reference
                # tokens but the last: roll back what the window wrote
                # past the first token off the reference
                cursor = len(waves[w][r - w * S]) + int(e[s]) - 1
                if paged:
                    eng.allocator.lengths[s] = cursor
                else:
                    eng.cache.lengths[s] = cursor
        for s in reqs:
            eng.release_slot(s)
    del eng
    return checked, allowed


def serve_spec(torch, kern, card: str, paged: bool):
    """``bench_gpt_decode_spec`` on the port, dense or paged (the module
    docstring): the plain and speculative legs, timed; (a)-(c) in bf16 and
    again in fp32; the verify step's time and launches. Returns the two
    legs' launch counts summed and the cursors of the speculative leg's
    middle verify step."""
    import numpy as np
    what = "paged speculative serving" if paged else "speculative serving"
    pattern, prompts = spec_workload(paged)
    model = spec_model(torch, torch.bfloat16)
    legs = {}
    for k, leg in ((0, "plain"), (SPEC_K, "speculative")):
        eng = spec_engine(torch, model, paged, k, torch.bfloat16)
        legs[leg] = spec_leg(torch, kern, eng, k, pattern, prompts, paged,
                             f"{what}, {leg} leg (k {k})", card)
        del eng
    plain, spec = legs["plain"], legs["speculative"]
    print(f"{what}: speculative {spec['tps']:.1f} tokens/s against plain "
          f"{plain['tps']:.1f} = {spec['tps'] / plain['tps']:.3f}x; accept "
          f"rate {spec['snap']['serve/spec_accept_rate']:.4f}, "
          f"{spec['steps']} speculative steps against {plain['steps']} plain "
          f"[{card}]")
    full = [c for c, active in spec["seen"] if active.all()]
    check(bool(full), f"{what}: no verify step with every slot live")
    cursors = [int(c) for c in full[len(full) // 2]]
    streams = {leg: legs[leg]["streams"] for leg in legs}
    spec_parity(torch, model, paged, torch.bfloat16, prompts, streams, card,
                f"{what} bf16")

    # the verify step at the bench's state: every slot prefilled, n-gram
    # drafts, beside the plain engine's decode step in turns
    e0 = spec_engine(torch, model, paged, 0, torch.bfloat16)
    e1 = spec_engine(torch, model, paged, SPEC_K, torch.bfloat16)
    S = SPEC["max_seqs"]
    for s in range(S):
        e0.prefill(prompts[s], s)
        e1.prefill(prompts[s], s)
    temps = np.zeros(S, np.float32)
    toks = np.array([p[-1] for p in prompts[:S]], np.int64)
    drafts = np.array([p[:SPEC_K] for p in prompts[:S]], np.int64)
    kern.reset_launches()
    e1.verify(toks, drafts, temps)
    torch.cuda.synchronize()
    per_step = {n: c for n, c in kern.LAUNCHES.items() if c}
    times = {"verify": [], "decode": []}
    for rep in range(4):
        for leg in (("verify", "decode") if rep % 2 == 0
                    else ("decode", "verify")):
            fn = ((lambda: e1.verify(toks, drafts, temps)) if leg == "verify"
                  else (lambda: e0.decode(toks, temps)))
            times[leg].append(1e3 * _host_time(torch, fn, 5))
    med = {leg: float(np.median(v)) for leg, v in times.items()}
    print(f"{what}: verify step (4 slots x {SPEC_K + 1} rows) "
          f"{med['verify']:.3f} ms, plain decode step {med['decode']:.3f} ms "
          f"(host clock, medians of 4 means of 5, in turns); the verify "
          f"step launches {per_step} [{card}]")
    profile_step(torch, f"{what} verify step",
                 lambda: e1.verify(toks, drafts, temps), card)
    del e0, e1, model

    # the fp32 repeat: fp32 cache and compute, same weights
    model = spec_model(torch, torch.float32)
    streams = {}
    for k, leg in ((0, "plain"), (SPEC_K, "speculative")):
        eng = spec_engine(torch, model, paged, k, torch.float32)
        streams[leg] = spec_leg(torch, kern, eng, k, pattern, prompts, paged,
                                f"{what} fp32, {leg} leg (k {k})",
                                card)["streams"]
        del eng
    spec_parity(torch, model, paged, torch.float32, prompts, streams, card,
                f"{what} fp32 ({model.cfg.num_layers} layers)")
    del model
    torch.cuda.empty_cache()
    launches = {n: plain["launches"][n] + spec["launches"][n]
                for n in plain["launches"]}
    return launches, cursors


def verify_cases(torch, cache_mod, paged: bool, cursors):
    """The verify step's attention inputs at ``SPEC``'s shape (4 slots x 12
    heads, 5 rows, d 64, bf16 q): ``(name, q, cache args, lengths, in-flight
    rows)`` at the run's cursors, at {0, 1, 127, 128} and at {1019, 1020}
    beside two more, with a bf16 and an int8 cache; paged over a shuffled
    33-block pool of 128-token blocks."""
    gen = torch.Generator(device="cuda").manual_seed(21 + paged)
    cpu_gen = torch.Generator().manual_seed(21)
    S, H, Q, d, T = SPEC["max_seqs"], 12, SPEC_K + 1, 64, SPEC["max_len"]
    bs, nb = SPEC_PAGED["block_size"], SPEC_PAGED["num_blocks"]

    def rand(shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    lead = (nb, H, bs) if paged else (S, H, T)
    kf, vf = rand((*lead, d), torch.float32), rand((*lead, d), torch.float32)
    caches = {"bf16": (kf.to(torch.bfloat16), vf.to(torch.bfloat16), {}),
              "int8": None}
    kq, ks = cache_mod._quantize(kf)
    vq, vs = cache_mod._quantize(vf)
    caches["int8"] = (kq, vq, {"k_scale": ks, "v_scale": vs})
    tables = None
    if paged:
        tables = (torch.randperm(nb - 1, generator=cpu_gen) + 1).view(
            S, -1).to(device="cuda", dtype=torch.int32)
    cases = []
    for label, lens in (("the run's cursors", cursors),
                        ("cursors 0, 1, 127, 128", [0, 1, 127, 128]),
                        ("cursors 1019, 1020, 255, 256",
                         [1019, 1020, 255, 256])):
        for dt, (k, v, sc) in caches.items():
            q, kn, vn = (rand((S, H, Q, d)) for _ in range(3))
            quant = dt == "int8"
            rows = {"k_new": kn, "v_new": vn,
                    "k_cast": cache_mod.store_roundtrip(kn, k.dtype, quant),
                    "v_cast": cache_mod.store_roundtrip(vn, k.dtype, quant)}
            lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
            cases.append((f"{label}, {dt} {'pool' if paged else 'cache'}",
                          q, k, v, sc, tables, lengths, rows))
    return cases


def check_verify_kernels(torch, fa, cache_mod, kern, card: str, cursors,
                         paged_cursors) -> None:
    """Both decode kernels at the verify step's shape: each launch against
    the plain version (out and lse) and repeated bit for bit, and the op
    with the in-flight rows merged (``decode_attention`` /
    ``paged_decode_attention`` with ``k_new``/``k_cast``) kernel against
    plain; then device times at q_len 5, 4 and 1 at the verify step's
    cursors beside the bound, and B4 at q_len 5 beside SDPA with a boolean
    mask."""
    for paged, curs in ((False, cursors), (True, paged_cursors)):
        name = "paged_decode_attention" if paged else "decode_attention"
        op = fa.paged_decode_attention if paged else fa.decode_attention
        worst = 0.0
        for what, q, k, v, sc, tables, lengths, rows in verify_cases(
                torch, cache_mod, paged, curs):
            S, H, Q, d = q.shape
            scale = d ** -0.5
            q3 = q.reshape(S * H, Q, d)
            if paged:
                args = (q3, k, v, tables, lengths, sc.get("k_scale"),
                        sc.get("v_scale"), scale)
                launch, plain = kern.paged_decode_attention, \
                    fa._paged_decode_plain
                cache = (k, v, tables, lengths)
            else:
                T = k.shape[2]
                sc3 = {n: s.reshape(S * H, T) for n, s in sc.items()}
                args = (q3, k.reshape(S * H, T, d), v.reshape(S * H, T, d),
                        lengths.repeat_interleave(H), sc3.get("k_scale"),
                        sc3.get("v_scale"), scale)
                launch, plain = kern.decode_attention, fa._decode_plain
                cache = (k, v, lengths)
            out_k, lse_k = launch(*args)
            same_bits(torch, f"{name} verify {what}", (out_k, lse_k),
                      launch(*args))
            out_p, lse_p = plain(*args)
            tol = tol_for(torch, q.dtype)
            err, share = close(torch, [(out_k, out_p)], tol)
            check(share <= 1, f"{name} verify {what}: out err {err:.3g}, "
                              f"{share:.3g} x the limit {tol}")
            lerr = compare_lse(torch, lse_k, lse_p, TOL_LSE,
                               f"{name} verify {what}")
            merged = op(q, *cache, **rows, **sc, use_kernel=True)
            same_bits(torch, f"{name} verify {what}, merged", (merged,),
                      (op(q, *cache, **rows, **sc, use_kernel=True),))
            merged_p = op(q, *cache, **rows, **sc, use_kernel=False)
            merr, mshare = close(torch, [(merged, merged_p)], tol)
            check(mshare <= 1, f"{name} verify {what}, merged: err "
                               f"{merr:.3g}, {mshare:.3g} x the limit {tol}")
            check(bool(torch.isfinite(merged).all()),
                  f"{name} verify {what}: merged output not finite")
            worst = max(worst, err, merr)
            print(f"{name} verify rows (4 x 12 x {Q}, d {d}, bf16 q), "
                  f"{what}: kernel vs plain out {err:.3g} ({share:.3g} x "
                  f"the limit), lse {lerr:.3g}; merged with the in-flight "
                  f"rows {merr:.3g} ({mshare:.3g} x); each launch repeated "
                  "bit for bit")
        print(f"{name} verify rows: max_abs_err {worst:.3g} over the cases "
              f"(bf16 limit {BF16_TOL})")
    verify_timings(torch, fa, kern, card, cursors, paged_cursors)


def verify_timings(torch, fa, kern, card: str, cursors,
                   paged_cursors) -> None:
    """B4 and B5 device times at the verify step's shape (4 slots x 12
    heads, d 64, bf16, max_len 1024 / 128-token blocks) at q_len 5, 4 and
    1, at the verify step's cursors, beside their plain versions and the
    bound (the live prefix's K and V read once, q read and out and lse
    written once, over HBM bandwidth, or the products over the bf16 peak);
    B4 at q_len 5 beside SDPA with a boolean mask of the cursors (a
    yardstick only). q_len 5 makes two groups of 4 rows a slot-head
    (``_kernels._decode_groups``), each reading the prefix."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    S, H, T, d = SPEC["max_seqs"], 12, SPEC["max_len"], 64
    bs, nb = SPEC_PAGED["block_size"], SPEC_PAGED["num_blocks"]
    n = S * H
    scale = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def rand(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    k, v = rand((n, T, d)), rand((n, T, d))
    kp, vp = rand((nb, H, bs, d)), rand((nb, H, bs, d))
    tables = (torch.randperm(nb - 1, generator=torch.Generator()
                             .manual_seed(23)) + 1).view(S, -1).to(
        device="cuda", dtype=torch.int32)
    for paged, curs in ((False, cursors), (True, paged_cursors)):
        name = "paged_decode_attention" if paged else "decode_attention"
        lengths = torch.tensor(curs, dtype=torch.int32, device="cuda")
        live = sum(curs) * H
        entries = sum(-(-c // bs) for c in curs)
        for q_len in (5, 4, 1):
            q = rand((n, q_len, d))
            if paged:
                args = (q, kp, vp, tables, lengths, None, None, scale)
                launch, plain = kern.paged_decode_attention, \
                    fa._paged_decode_plain
            else:
                args = (q, k, v, lengths.repeat_interleave(H), None, None,
                        scale)
                launch, plain = kern.decode_attention, fa._decode_plain
            ms = device_ms(torch, lambda: launch(*args))
            plain_ms = device_ms(torch, lambda: plain(*args))
            nbytes = (2 * live * d * 2 + 2 * nbytes_of(q) + n * q_len * 4
                      + nbytes_of(lengths) + (entries * 4 if paged else 0))
            b_ms, b_by = bound(nbytes, 2 * 2 * live * d * q_len)
            lib = ""
            if not paged and q_len == 5:
                q4 = q.view(S, H, q_len, d)
                k4, v4 = k.view(S, H, T, d), v.view(S, H, T, d)
                mask = (torch.arange(T, device="cuda")[None, :]
                        < lengths[:, None])[:, None, None, :]
                lib_ms = device_ms(torch, lambda: sdpa(q4, k4, v4,
                                                       attn_mask=mask))
                lib = f", SDPA with a boolean mask {lib_ms:.4f} ms"
            groups = kern._decode_groups(n, q_len) // n
            splits = kern.decode_splits(n, tables.shape[1] * bs if paged
                                        else T, q_len)
            print(f"{name} timing at the verify step's cursors {curs}, "
                  f"q_len {q_len} ({groups} row group(s) a slot-head, "
                  f"{splits} chunks): kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms{lib}, bound {b_ms:.5f} ms ({b_by}; "
                  f"{nbytes / 1e6:.3f} MB) [{card}]")


# ---------------------------------------------------------------------------
# phase 5: GPT-small training
# ---------------------------------------------------------------------------

# bench.py's DECODE_SLO: the serving SLO gpt_decode_goodput is scored under
DECODE_SLO = (("ttft_ms", 95.0, 2000.0), ("tpot_ms", 99.0, 500.0))
GOODPUT_SLOTS = (1, 8)
CHAOS_SEED = 23
CHAOS_NEW_TOKENS = 16
# what a quarantine engine's step may add, in kernel launches: the poison
# add, isfinite's four elementwise ops, the all-reduction, the flags' cast
# and, for decode, the concatenation into the step's one host copy
# (tests/test_torch_resilience.py::QUARANTINE_EXTRA counts the same ops)
QUARANTINE_LAUNCHES = {"decode": 8, "verify": 7}


def host_knobs() -> dict:
    """Every host knob of the scheduler, attached: a request trace, an SLO
    tracker, a queue bound, a default deadline, a brownout policy and an
    empty fault plan."""
    from apex_tpu_torch.elastic import FaultPlan
    from apex_tpu_torch.observability import (MetricsRegistry, RequestTrace,
                                              SLOTarget, SLOTracker)
    from apex_tpu_torch.serving import BrownoutPolicy
    tracker = SLOTracker([SLOTarget(m, q, t) for m, q, t in DECODE_SLO],
                         registry=MetricsRegistry(), on_violation="skip")
    return dict(trace=RequestTrace(256), slo=tracker, max_queue=64,
                default_deadline_ms=120000.0,
                brownout=BrownoutPolicy(tracker, cap_max_new_tokens=1024),
                fault_plan=FaultPlan())


def path_launches(kern, L: int, what: str, steps: int, prefills: int,
                  kernel: str, passes: int) -> dict:
    """The launch counts since the last reset, checked: ``kernel`` ``L``
    times a step, ``flash_fwd`` ``L`` times a prefill, ``ln_fwd``
    ``LN_PER_GPT_PASS`` times a pass, nothing else of the path's
    kernels."""
    got = dict(kern.LAUNCHES)
    other = ("paged_decode_attention" if kernel == "decode_attention"
             else "decode_attention")
    check(got[kernel] == L * steps,
          f"{what}: {kernel} launches {got[kernel]} != {L} x {steps} steps")
    check(got[other] == 0, f"{what}: launched {other}")
    check(got["flash_fwd"] == L * prefills,
          f"{what}: flash_fwd launches {got['flash_fwd']} != {L} x "
          f"{prefills} prefills")
    check(got["ln_fwd"] == LN_PER_GPT_PASS * passes and got["ln_bwd"] == 0,
          f"{what}: ln_fwd/ln_bwd launches {got['ln_fwd']}/{got['ln_bwd']} "
          f"!= {LN_PER_GPT_PASS} x {passes} passes / 0")
    return got


def add_launches(total: dict, got: dict) -> dict:
    return {n: total.get(n, 0) + got[n] for n in got}


def serve_goodput(torch, kern, card: str, model) -> dict:
    """``bench.py::bench_gpt_decode``'s ``serve_leg`` on the port at 1 and
    8 slots: 2 x slots requests (prompt ``prompt[: 1 + (3 i) % 128]``, 8
    new tokens) under ``DECODE_SLO`` with a ``RequestTrace`` and an
    ``SLOTracker``, then a burst of 4 x slots requests (``prompt[: 1 +
    i]``, 4 new tokens) at ``max_queue = slots`` and
    ``default_deadline_ms = 120000``. Each engine first serves one warm
    request. Returns the launch counts of the two drives summed."""
    import numpy as np
    from apex_tpu_torch.observability import (LATENCY_BUCKETS_MS,
                                              MetricsRegistry, RequestTrace,
                                              SLOTarget, SLOTracker)
    from apex_tpu_torch.serving import (Rejection, Request, ServingEngine,
                                        SlotScheduler)
    cfg = model.cfg
    L = cfg.num_layers
    targets = tuple(SLOTarget(m, q, t) for m, q, t in DECODE_SLO)
    prompt = np.random.RandomState(0).randint(1, cfg.vocab_size,
                                              size=128).tolist()
    total = {}
    for slots in GOODPUT_SLOTS:
        what = f"serve_goodput ({slots} slots)"
        eng = ServingEngine(model, max_seqs=slots, max_len=1024,
                            prefill_len=128, cache_dtype=torch.bfloat16,
                            rng_seed=0, device="cuda")
        SlotScheduler(eng, registry=MetricsRegistry()).run(
            [Request(prompt=prompt[:4], max_new_tokens=2)])
        sreg = MetricsRegistry()
        tracker = SLOTracker(targets, registry=sreg,
                             trace=RequestTrace(capacity=64),
                             on_violation="skip")
        sched = SlotScheduler(eng, registry=sreg, trace=tracker.trace,
                              slo=tracker)
        reqs = [Request(prompt=prompt[: 1 + (3 * i) % 128], max_new_tokens=8)
                for i in range(2 * slots)]
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        done = sched.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total = add_launches(total, path_launches(
            kern, L, what, sched.steps, len(reqs), "decode_attention",
            len(reqs) + sched.steps))
        check(len(done) == len(reqs) and all(
            c.finish_reason == "length" and len(c.tokens) == 8
            for c in done.values()),
            f"{what}: {len(done)} of {len(reqs)} requests completed whole")
        check(len(tracker.trace) == len(reqs),
              f"{what}: {len(tracker.trace)} trace records")
        json.dumps(tracker.trace.chrome_trace(), allow_nan=False)
        pct = {}
        for short, name in (("ttft", "serve/ttft_ms"),
                            ("tpot", "serve/tpot_ms")):
            hist = sreg.histogram(name, LATENCY_BUCKETS_MS)
            pct.update({f"{short}_p{q}": float(hist.percentile(q))
                        for q in (50, 95, 99)})
        goodput = tracker.goodput()

        # the burst at 4x the queue bound on the same engine
        t2 = SLOTracker(targets, registry=sreg, on_violation="skip")
        over = SlotScheduler(eng, registry=sreg, slo=t2, max_queue=slots,
                             default_deadline_ms=120000.0)
        torch.cuda.synchronize()
        kern.reset_launches()
        burst, depth = [], 0
        for i in range(4 * slots):
            burst.append(over.submit(Request(prompt=prompt[: 1 + i],
                                             max_new_tokens=4)))
            depth = max(depth, len(over.queue))
        while over.pending:
            over.step()
            depth = max(depth, len(over.queue))
        torch.cuda.synchronize()
        admitted = [b for b in burst if not isinstance(b, Rejection)]
        total = add_launches(total, path_launches(
            kern, L, f"{what} burst", over.steps, len(admitted),
            "decode_attention", len(admitted) + over.steps))
        snap = sreg.snapshot()
        rejected = int(snap.get("serve/rejected", 0.0))
        expired = int(snap.get("serve/expired", 0.0))
        check(rejected == len(burst) - len(admitted),
              f"{what}: serve/rejected {rejected} != "
              f"{len(burst) - len(admitted)} submits that returned a "
              "Rejection")
        check(all(b.reason == "queue_full" for b in burst
                  if isinstance(b, Rejection)),
              f"{what}: a burst rejection other than queue_full")
        finished = {c.request_id: c.finish_reason for c in over.completed}
        check(sorted(finished) == sorted(admitted)
              and set(finished.values()) <= {"length"},
              f"{what}: admitted {sorted(admitted)}, completed {finished}")
        check(depth <= slots, f"{what}: queue depth {depth} > {slots}")
        # capacity: the allocator's peak over a decode step, less the cache
        params = sum(t.numel() * t.element_size()
                     for t in model.state_dict().values())
        overhead = eng.overhead_bytes()
        hbm = torch.cuda.get_device_properties(0).total_memory
        check(isinstance(overhead, int) and overhead >= params,
              f"{what}: overhead_bytes {overhead} below the parameters' "
              f"{params}")
        print(f"{what}: overhead_bytes {overhead} (parameters {params}, "
              f"cache {eng.cache.nbytes()}), suggest_max_seqs({hbm}) "
              f"{eng.suggest_max_seqs(hbm)} [{card}]")
        print(f"{what}: {len(reqs)} requests, {sched.steps} steps in "
              f"{wall:.3f} s; TTFT p50/p95/p99 {pct['ttft_p50']:.3f}/"
              f"{pct['ttft_p95']:.3f}/{pct['ttft_p99']:.3f} ms, TPOT "
              f"p50/p95/p99 {pct['tpot_p50']:.3f}/{pct['tpot_p95']:.3f}/"
              f"{pct['tpot_p99']:.3f} ms; goodput {100 * goodput:.2f}% "
              f"under {'; '.join(t.describe() for t in targets)}; burst of "
              f"{len(burst)} at max_queue {slots}: {len(admitted)} admitted, "
              f"rejected {rejected}, expired {expired}, queue depth at most "
              f"{depth}, overload goodput {100 * t2.goodput():.2f}% [{card}]")
        del eng
    torch.cuda.empty_cache()
    return total


def strict_json(path: str) -> dict:
    """A file parsed as strict JSON (no NaN or Infinity literals)."""
    def refuse(name):
        raise ValueError(f"{path}: non-standard JSON literal {name}")

    with open(path) as f:
        return json.loads(f.read(), parse_constant=refuse)


def strict_jsonl(path: str) -> list:
    """A JSON-lines file, each line parsed as strict JSON."""
    def refuse(name):
        raise ValueError(f"{path}: non-standard JSON literal {name}")

    with open(path) as f:
        return [json.loads(line, parse_constant=refuse) for line in f]


def chaos_leg(torch, kern, card: str, eng, k: int, what: str,
              dump_dir: str) -> dict:
    """``FaultPlan.sample_serving`` on a quarantine engine: the fault-free
    run of 4 x slots requests gives ``total_steps``; the plan (``flood_n``
    4, ``slow_decode_s`` 0.002) is drawn from ``CHAOS_SEED``; the same
    schedule with the flood alone gives every stream's reference; the
    faulted run, its launches counted, must retire exactly the poisoned
    slot ``"poisoned"`` with a strict-JSON dump and leave every other
    stream equal to the reference, token for token."""
    import numpy as np
    from apex_tpu_torch.elastic import FaultPlan
    from apex_tpu_torch.observability import MetricsRegistry, RequestTrace
    from apex_tpu_torch.serving import Rejection, Request, SlotScheduler
    S, L = eng.max_seqs, eng.model.cfg.num_layers
    vocab = eng.model.cfg.vocab_size

    def drive(plan):
        reg, trace = MetricsRegistry(), RequestTrace(256)
        sched = SlotScheduler(eng, registry=reg, trace=trace,
                              max_queue=4 * S, fault_plan=plan,
                              dump_dir=dump_dir, speculate_k=k)
        rs = np.random.RandomState(1)

        def fresh(i):
            n = 8 + int(rs.randint(57))
            return Request(prompt=rs.randint(1, vocab, size=n).tolist(),
                           max_new_tokens=CHAOS_NEW_TOKENS,
                           request_id=100 + i)

        # four waves keep every slot busy past the poison step, drawn in
        # the second half of the fault-free run (an idle slot's poison
        # would inject nothing)
        for i in range(4 * S):
            sched.submit(fresh(i))
        submitted, rejected = 4 * S, 0
        while sched.pending:
            if plan is not None:
                for _ in range(plan.flood_n(sched.steps + 1)):
                    rejected += isinstance(sched.submit(fresh(submitted)),
                                           Rejection)
                    submitted += 1
            sched.step()
        return sched, reg, trace, rejected

    total_steps = drive(None)[0].steps
    plan = FaultPlan.sample_serving(CHAOS_SEED, total_steps, max_slots=S,
                                    flood_n=4, slow_decode_s=0.002)
    (pstep, pslot), = plan.poison_logits.items()
    clean = {c.request_id: c for c in
             drive(FaultPlan(flood=dict(plan.flood)))[0].completed}
    torch.cuda.synchronize()
    kern.reset_launches()
    sched, reg, trace, rejected = drive(plan)
    torch.cuda.synchronize()
    snap = reg.snapshot()
    kernel = ("paged_decode_attention" if hasattr(eng, "allocator")
              else "decode_attention")
    got = path_launches(kern, L, what, sched.steps,
                        int(snap["serve/admitted"]), kernel,
                        int(snap["serve/admitted"]) + sched.steps)
    poisoned = [c for c in sched.completed if c.finish_reason == "poisoned"]
    check(len(poisoned) == 1 and snap["serve/poisoned"] == 1.0,
          f"{what}: {len(poisoned)} poisoned retirements")
    rec = next(r for r in trace.records()
               if r.request_id == poisoned[0].request_id)
    check(rec.slot == pslot, f"{what}: slot {rec.slot} retired poisoned, "
                             f"the plan poisoned slot {pslot}")
    check(len(sched.poison_dumps) == 1, f"{what}: {sched.poison_dumps}")
    dump = strict_json(sched.poison_dumps[0])
    check(dump["config"]["slot"] == pslot and dump["step"] == pstep,
          f"{what}: poison dump config {dump['config']}, step "
          f"{dump['step']}")
    check(sorted(c.request_id for c in sched.completed) == sorted(clean),
          f"{what}: the faulted run completed other requests than the "
          "clean one")
    p = poisoned[0]
    check(p.tokens == clean[p.request_id].tokens[:len(p.tokens)],
          f"{what}: the poisoned request's tokens before the poison differ")
    same = 0
    for c in sched.completed:
        if c is p:
            continue
        check(c.tokens == clean[c.request_id].tokens
              and c.finish_reason == clean[c.request_id].finish_reason,
              f"{what}: request {c.request_id} differs from the fault-free "
              "run")
        same += len(c.tokens)
    counters = {n: int(v) for n, v in snap.items()
                if n in ("serve/admitted", "serve/retired",
                         "serve/poisoned", "serve/rejected",
                         "serve/decode_steps", "serve/generated_tokens",
                         "serve/spec_steps", "serve/spec_accepted",
                         "serve/spec_drafted")}
    print(f"{what}: total_steps {total_steps} from the fault-free run; plan "
          f"flood {plan.flood}, poison step {pstep} slot {pslot}, slow "
          f"{plan.slow_decode_s} s; {len(sched.completed)} completions, "
          f"request {p.request_id} poisoned after {len(p.tokens)} tokens "
          f"(a prefix of its fault-free stream), the other "
          f"{len(sched.completed) - 1} equal to the fault-free run over "
          f"{same} tokens; {rejected} flood submits rejected; counters "
          f"{counters}; dump {sched.poison_dumps[0]} strict JSON [{card}]")
    return got


def resilience_checks(torch, eng, model, card: str, dump_dir: str) -> None:
    """On a dense quarantine engine: cancel queued and mid-flight, a queued
    and a mid-flight expiry, ``drain`` then ``swap_params`` to seed 1's
    weights (the greedy stream changes; the seed-0 weights are put back
    after), and an injected decode fault (every in-flight request retired
    ``"error"``, then a new request served)."""
    import numpy as np
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.observability import MetricsRegistry
    from apex_tpu_torch.serving import Request, SlotScheduler
    S = eng.max_seqs
    rs = np.random.RandomState(2)
    prompts = [rs.randint(1, model.cfg.vocab_size, size=16).tolist()
               for _ in range(2 * S + 2)]

    reg = MetricsRegistry()
    sched = SlotScheduler(eng, registry=reg, dump_dir=dump_dir)
    ids = [sched.submit(Request(prompt=p, max_new_tokens=8))
           for p in prompts[:S + 1]]
    sched.step()
    check(len(sched.active) == S and len(sched.queue) == 1,
          "cancel: the grid is not full with one queued")
    calls = (sched.cancel(ids[-1]), sched.cancel(ids[0]),
             sched.cancel(ids[0]), sched.cancel(10 ** 6))
    sched.run([])
    reasons = {c.request_id: c.finish_reason for c in sched.completed}
    check(calls == (True, True, False, False)
          and reasons[ids[-1]] == reasons[ids[0]] == "cancelled"
          and all(reasons[i] == "length" for i in ids[1:-1])
          and reg.snapshot()["serve/cancelled"] == 2.0,
          f"cancel: calls {calls}, reasons {reasons}")

    reg = MetricsRegistry()
    sched = SlotScheduler(eng, registry=reg)
    long = sched.submit(Request(prompt=prompts[0], max_new_tokens=900,
                                deadline_ms=250.0))
    for p in prompts[1:S]:
        sched.submit(Request(prompt=p, max_new_tokens=4))
    queued = sched.submit(Request(prompt=prompts[S], max_new_tokens=4,
                                  deadline_ms=1.0))
    sched.run([])
    out = {c.request_id: c for c in sched.completed}
    check(out[queued].finish_reason == "expired" and not out[queued].tokens
          and out[long].finish_reason == "expired"
          and 1 <= len(out[long].tokens) < 900
          and reg.snapshot()["serve/expired"] == 2.0,
          f"expiry: queued {out[queued].finish_reason}, mid-flight "
          f"{out[long].finish_reason} after {len(out[long].tokens)} tokens")
    expiry = (len(out[long].tokens), out[long].e2e_ms)

    probe = prompts[-1]

    def probe_stream():
        return SlotScheduler(eng, registry=MetricsRegistry()).run(
            [Request(prompt=probe, max_new_tokens=8)])

    before = next(iter(probe_stream().values())).tokens
    reg = MetricsRegistry()
    sched = SlotScheduler(eng, registry=reg)
    for p in prompts[:2 * S]:
        sched.submit(Request(prompt=p, max_new_tokens=6))
    sched.step()
    done = sched.drain()
    check(len(done) == S and all(c.finish_reason == "length"
                                 for c in done.values())
          and len(sched.queue) == S and not sched.draining,
          f"drain: {len(done)} drained, {len(sched.queue)} queued")
    seed0 = {n: t.clone() for n, t in model.state_dict().items()}
    seed1 = GPTModel(model.cfg, device="cuda").init(
        torch.Generator().manual_seed(1)).state_dict()
    sched.swap_params(seed1)
    try:
        rest = sched.run([])
        after = next(iter(probe_stream().values())).tokens
    finally:
        eng.swap_params(seed0)
    check(len(rest) == S and all(c.finish_reason == "length"
                                 for c in rest.values())
          and reg.snapshot()["serve/swaps"] == 1.0
          and reg.snapshot()["serve/drains"] == 1.0,
          f"swap: {len(rest)} served after the swap")
    check(after != before, "swap: the greedy stream did not change")
    check(next(iter(probe_stream().values())).tokens == before,
          "swap: the seed-0 stream did not come back")

    reg = MetricsRegistry()
    sched = SlotScheduler(eng, registry=reg)
    for p in prompts[:S]:
        sched.submit(Request(prompt=p, max_new_tokens=8))
    sched.step()

    def boom(*args, **kw):
        raise RuntimeError("injected decode fault")

    eng.decode = boom
    try:
        sched.step()
        fail("the injected decode fault did not propagate")
    except RuntimeError as exc:
        check("injected decode fault" in str(exc), f"decode fault: {exc}")
    finally:
        del eng.decode
    errors = [c for c in sched.completed if c.finish_reason == "error"]
    check(len(errors) == S and not sched.active
          and sorted(sched.free) == list(range(S))
          and reg.snapshot()["serve/errors"] == float(S),
          f"decode fault: {len(errors)} retired error, "
          f"{len(sched.active)} still active")
    post = sched.run([Request(prompt=probe, max_new_tokens=8)])
    check(len(post) == 1 and next(iter(post.values())).tokens == before,
          "decode fault: the scheduler did not serve a new request")
    print(f"serve_chaos resilience: cancel queued and mid-flight {calls}; "
          f"expiry queued (1 ms) and mid-flight (250 ms, after "
          f"{expiry[0]} tokens, e2e {expiry[1]:.3f} ms); drain {len(done)} "
          f"in flight, {S} kept queued, served after swap_params to seed "
          f"1's weights; probe stream {before} -> {after}; decode fault "
          f"retired {len(errors)} error, then served the probe again "
          f"[{card}]")


def serve_chaos(torch, kern, card: str, model) -> dict:
    """The chaos plan on three quarantine engines: dense decode at 8 slots,
    paged decode (``gpt_decode_paged``'s pool) and dense speculative
    (``speculate_k`` 4) at 4 slots; then the resilience checks on the dense
    one. Returns the faulted runs' launch counts summed."""
    import tempfile
    from apex_tpu_torch.serving import PagedServingEngine, ServingEngine
    total = {}
    with tempfile.TemporaryDirectory(prefix="poison_dumps_",
                                     dir=".") as dump_dir:
        legs = (("dense decode (8 slots)", 0, lambda: ServingEngine(
                    model, max_seqs=8, max_len=1024, prefill_len=128,
                    cache_dtype=torch.bfloat16, quarantine=True,
                    device="cuda")),
                ("paged decode (8 slots, 128-token blocks)", 0,
                 lambda: PagedServingEngine(
                     model, cache_dtype=torch.bfloat16, quarantine=True,
                     device="cuda", **PAGED)),
                (f"dense speculative (4 slots, k {SPEC_K})", SPEC_K,
                 lambda: ServingEngine(
                     model, cache_dtype=torch.bfloat16, quarantine=True,
                     speculate_k=SPEC_K, device="cuda", **SPEC)))
        for i, (name, k, make) in enumerate(legs):
            eng = make()
            total = add_launches(total, chaos_leg(
                torch, kern, card, eng, k, f"serve_chaos {name}", dump_dir))
            if i == 0:
                resilience_checks(torch, eng, model, card, dump_dir)
            del eng
    torch.cuda.empty_cache()
    return total


def step_counts(torch, fn) -> dict:
    """Device activities of one call of ``fn`` under ``torch.profiler``, by
    name: kernels, and memcpys (their names say ``DtoH`` or ``HtoD``). The
    window records a second call, after a warm-up call the profiler traces
    and drops: a window that opened on the step itself now and then lost
    the step's first events (PR 11: 17 launches and 4 host-to-device copies
    of a verify step; PR 13: one variant's four windows read them once in
    four). A window the profiler recorded no kernel in is taken again
    (PERF.md §7)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(3):
        active = []   # the recorded step's events, read as its cycle ends
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: active.extend(
                         p.key_averages())) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        seen = {}
        for e in active:
            if e.device_type == DeviceType.CUDA and "Memset" not in e.key:
                seen[e.key] = seen.get(e.key, 0) + e.count
        if any("Memcpy" not in k for k in seen):
            return seen
    fail("host_cost_off: the profiler recorded no kernel in three windows")


def step_totals(seen: dict) -> tuple:
    """``(kernel launches, DtoH copies, HtoD copies)`` of a window."""
    kernels = sum(n for k, n in seen.items() if "Memcpy" not in k)
    return (kernels, sum(n for k, n in seen.items() if "DtoH" in k),
            sum(n for k, n in seen.items() if "HtoD" in k))


# one-step profiler windows a variant is read over (each after a warm-up
# step); should a window still come back short, its first events lost
# (never long: the step before it ends in a sync, and nothing launches
# after its one copy), the largest reading of each count is the step's
HOST_COST_WINDOWS = 4


def host_cost_off(torch, card: str, model) -> None:
    """One steady decode step of the dense engine (8 slots), of the paged
    engine and one verify step (4 slots, ``speculate_k`` 4), each under
    ``torch.profiler``: a bare scheduler against one with every host knob
    attached (:func:`host_knobs`) must launch as many kernels and copy to
    the host as often; a quarantine engine may add at most
    ``QUARANTINE_LAUNCHES`` launches and no copy. Each variant is read
    over ``HOST_COST_WINDOWS`` steps, one window each, and judged by the
    largest reading of each count (a short window loses its first
    events: PERF.md §7); every window is printed."""
    import numpy as np
    from apex_tpu_torch.observability import MetricsRegistry
    from apex_tpu_torch.serving import (PagedServingEngine, Request,
                                        ServingEngine, SlotScheduler)
    rs = np.random.RandomState(3)
    kinds = (("dense decode step (8 slots)", 0, lambda q: ServingEngine(
                  model, max_seqs=8, max_len=1024, prefill_len=128,
                  cache_dtype=torch.bfloat16, quarantine=q, device="cuda")),
             ("paged decode step (8 slots)", 0,
              lambda q: PagedServingEngine(
                  model, cache_dtype=torch.bfloat16, quarantine=q,
                  device="cuda", **PAGED)),
             (f"verify step (4 slots, k {SPEC_K})", SPEC_K,
              lambda q: ServingEngine(
                  model, cache_dtype=torch.bfloat16, quarantine=q,
                  speculate_k=SPEC_K, device="cuda", **SPEC)))
    for what, k, make in kinds:
        S = 4 if k else 8
        prompts = [rs.randint(1, model.cfg.vocab_size, size=64).tolist()
                   for _ in range(S)]
        most, windows = {}, {}
        for variant, knobs, quarantine in (("bare", False, False),
                                           ("every knob", True, False),
                                           ("quarantine", False, True)):
            sched = SlotScheduler(make(quarantine),
                                  registry=MetricsRegistry(), speculate_k=k,
                                  **(host_knobs() if knobs else {}))
            for p in prompts:
                sched.submit(Request(prompt=p, max_new_tokens=512))
            for _ in range(3):        # admission, then two warm steps
                sched.step()
            check(len(sched.active) == S and not sched.queue,
                  f"host_cost_off {what}: {len(sched.active)} active")
            seen = [step_counts(torch, sched.step)
                    for _ in range(HOST_COST_WINDOWS)]
            windows[variant] = [step_totals(w) for w in seen]
            most[variant] = tuple(max(col) for col in zip(*windows[variant]))
            if len(set(windows[variant])) > 1:
                # which names a short window lost
                names = sorted(set().union(*seen))
                print(f"host_cost_off {what} {variant}: windows differ in "
                      + "; ".join(f"{n[:60]} {[w.get(n, 0) for w in seen]}"
                                  for n in names
                                  if len({w.get(n, 0) for w in seen}) > 1))
            del sched
        bare, knobs, quar = (most[v] for v in ("bare", "every knob",
                                              "quarantine"))
        check(knobs[:2] == bare[:2],
              f"host_cost_off {what}: every knob {knobs} (launches, DtoH, "
              f"HtoD) against bare {bare}")
        extra = quar[0] - bare[0]
        limit = QUARANTINE_LAUNCHES["verify" if k else "decode"]
        check(0 < extra <= limit and quar[1] == bare[1],
              f"host_cost_off {what}: quarantine {quar} against bare {bare}"
              f" (at most {limit} more launches, no more DtoH copies)")
        print(f"host_cost_off {what}: (launches, DtoH copies, HtoD copies), "
              f"the most of {HOST_COST_WINDOWS} one-step windows: bare "
              f"{bare}, every host knob {knobs}, quarantine {quar}: {extra} "
              f"launches more, at most {limit}; every window {windows} "
              f"[{card}]")
    torch.cuda.empty_cache()


def grad_rel(torch, got: dict, want: dict) -> tuple:
    """The worst leaf's ``||got - want|| / ||want||`` over two name ->
    grad maps, and the leaf's name."""
    return max((float((got[n] - w).norm() / w.norm().clamp(min=1e-30)), n)
               for n, w in want.items())


def gpt_trainer(torch, cfg, init_state: dict, tokens, lr: float,
                opt_wrap=None, grad_sync=None, optimizer=None,
                finite_axes=None, tracker_seed=None):
    """A step function of ``bench.py::_gpt_train_step``'s training step on
    a ``GPTModel(cfg)`` loaded from ``init_state``: ``GPTModel.loss`` on
    ``tokens`` (the targets too), backward of the scaled loss, unscale,
    ``all_finite``, ``DynamicLossScale.update`` (init scale 2**12) and
    ``FusedAdam(lr).step`` with the skip (``opt_wrap(FusedAdam(lr))`` with
    ``opt_wrap``; ``optimizer`` in place of ``FusedAdam(lr)``); with a
    dropout rate in ``cfg``, the masks from a generator on the card seeded
    0, or with ``tracker_seed`` from an ``RNGStatesTracker`` stream on the
    card seeded so, at a step called with ``dropout=True`` only.
    ``grad_sync`` maps the scaled grads before the unscale (DDP's
    ``sync_gradients``), and ``finite_axes`` reduces the finite flag
    across ranks. ``step(extra=f)`` adds ``f(params)`` to the objective
    that is scaled and differentiated (a planted term), not to the loss
    it returns. The step returns ``(loss, finite, unscaled grads)``;
    ``step.params`` are the model's parameters, ``step.opt_state`` the
    optimizer's state and ``step.carry["ls"]`` the loss-scale state;
    ``step.state()`` is the tree a checkpoint holds, ``step.load(tree)``
    puts a restored one back."""
    from apex_tpu_torch.amp import DynamicLossScale, all_finite
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.tensor_parallel.random import (
        RNGStatesTracker)
    from torch.utils._pytree import tree_leaves

    model = GPTModel(cfg, device="cuda")
    model.load_state_dict(init_state)
    params = dict(model.named_parameters())
    opt = FusedAdam(lr=lr) if optimizer is None else optimizer
    if opt_wrap is not None:
        opt = opt_wrap(opt)
    opt_state = opt.init(params)
    scaler = DynamicLossScale(init_scale=2.0 ** 12)
    carry = {"ls": scaler.init(device="cuda")}
    rate = max(cfg.hidden_dropout, cfg.attention_dropout)
    tracker = None
    if tracker_seed is not None:
        tracker = RNGStatesTracker(device="cuda")
        tracker.add("model-parallel-rng", tracker_seed)
    gen = torch.Generator(device="cuda").manual_seed(0) \
        if rate and tracker is None else None

    def step(dropout: bool = False, extra=None):
        ls = carry["ls"]
        for p in params.values():
            p.grad = None
        g = tracker.make_key() if tracker is not None and dropout else gen
        loss = model.loss(tokens, tokens, generator=g)
        objective = loss if extra is None else loss + extra(params)
        (objective * ls.loss_scale).backward()
        grads = {n: p.grad for n, p in params.items()}
        if grad_sync is not None:
            grads = grad_sync(grads)
        grads = scaler.unscale(ls, grads)
        finite = all_finite(grads, axis_names=finite_axes)
        carry["ls"] = scaler.update(ls, finite)
        opt.step(grads, opt_state, params, grads_finite=finite)
        return loss.detach(), finite, grads

    def state():
        tree = {"params": params, "opt": opt_state, "ls": carry["ls"]}
        if tracker is not None:
            tree["rng"] = tracker.get_states()
        return tree

    def load(tree):
        # in place, so ``step.opt_state`` stays the live state (and no
        # closure refers to ``step``: a cycle would keep the model alive
        # past ``del step`` until the collector runs)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(tree["params"][n])
            for dst, src in zip(tree_leaves(opt_state),
                                tree_leaves(tree["opt"])):
                dst.copy_(src)
        carry["ls"] = tree["ls"]
        if tracker is not None:
            tracker.set_states(tree["rng"])

    step.generator = gen
    step.model = model
    step.params = params
    step.opt_state = opt_state
    step.carry = carry
    step.state, step.load = state, load
    return step


def train(torch, kern, card: str):
    """GPT-small training steps at full width, the twin of
    ``bench.py::_gpt_train_step``: ``GPTModel.loss``, backward of the
    scaled loss, unscale, ``all_finite``, ``DynamicLossScale.update``,
    ``FusedAdam.step`` with the skip. Each step launches each flash kernel
    once per layer. Then the plain path (``use_kernel=False``) takes the
    same steps from the same state dict: the losses and step 0's grads are
    compared. Last, one step of each path with train-mode dropout. Returns
    the launch counts of the kernel path's steps."""
    import numpy as np
    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_attention_heads=12, max_position_embeddings=1024)
    batch, seq = TRAIN_BH[0], TRAIN_ATTN[1]
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    init = GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init

    def trainer(use_kernel: bool, rate: float = 0.0):
        return gpt_trainer(torch, dataclasses.replace(
            cfg, use_kernel=use_kernel, hidden_dropout=rate,
            attention_dropout=rate), init_state, tokens, 1e-4)

    L = cfg.num_layers
    flash = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")

    def check_counts(counts: dict, what: str) -> None:
        for name in flash:
            check(counts[name] == L, f"{what}: {name} launched "
                                     f"{counts[name]} times, not {L}")
        for name in ("ln_fwd", "ln_bwd"):
            check(counts[name] == LN_PER_GPT_PASS,
                  f"{what}: {name} launched {counts[name]} times, not "
                  f"{LN_PER_GPT_PASS}")
        check(counts["decode_attention"] == 0
              and counts["paged_decode_attention"] == 0
              and counts["flash_dbias"] == 0
              and counts["flash_dbias_fold"] == 0,
              f"{what} launched a decode kernel or a dbias kernel")

    step = trainer(True)
    launches = {name: 0 for name in kern.LAUNCHES}
    losses, times = [], []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        loss, finite, grads = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(kern.LAUNCHES)
        check_counts(counts, f"train step {i}")
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"train step {i}: loss {float(loss)} or grads not finite")
        for name, n in counts.items():
            launches[name] += n
        losses.append(float(loss))
        if i == 0:
            grads0 = grads
        del grads
        print(f"train step {i}: loss {losses[-1]:.6f}, {1e3 * times[-1]:.3f} "
              f"ms (host clock, synchronized), launches {counts} [{card}]")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_n = batch * seq
    print(f"train: GPT-small (batch {batch} x seq {seq}, bf16 compute, fp32 "
          f"params), median step {1e3 * steady:.3f} ms after the first "
          f"({1e3 * times[0]:.3f} ms), {tokens_n / steady:.1f} tokens/s; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB [{card}]")
    profile_step(torch, "train step (8 x 1024 tokens)", step, card, iters=2,
                 top=12)
    del step
    torch.cuda.empty_cache()

    # the plain path from the same state dict: no kernel launch, the same
    # losses, and step 0's grads leaf by leaf
    plain = trainer(False)
    kern.reset_launches()
    worst = 0.0
    for i in range(TRAIN_COMPARE_STEPS):
        loss, finite, grads = plain()
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"plain train step {i}: loss or grads not finite")
        err = abs(float(loss) - losses[i])
        worst = max(worst, err)
        print(f"train step {i}: plain-path loss {float(loss):.6f}, kernel "
              f"path {losses[i]:.6f}, |diff| {err:.3g}")
        if i == 0:
            g_err, g_leaf = grad_rel(torch, grads0, grads)
        del grads
    del plain, grads0
    torch.cuda.empty_cache()
    check(sum(kern.LAUNCHES.values()) == 0, "the plain path launched kernels")
    check(worst <= TOL_TRAIN_LOSS, f"train loss kernel vs plain {worst:.3g} "
                                   f"> {TOL_TRAIN_LOSS}")
    check(g_err <= TOL_TRAIN_GRAD, f"step 0 grads kernel vs plain: {g_leaf} "
                                   f"{g_err:.3g} > {TOL_TRAIN_GRAD}")
    print(f"train: losses kernel path vs plain path over "
          f"{TRAIN_COMPARE_STEPS} steps: max |diff| {worst:.4g} (tol "
          f"{TOL_TRAIN_LOSS}); step 0's unscaled grads, worst leaf "
          f"{g_leaf}: ||kernel - plain|| / ||plain|| {g_err:.4g} (tol "
          f"{TOL_TRAIN_GRAD})")

    # train-mode dropout, hidden and attention, generator on the card: one
    # step of each path from the same state dict and generator seed. Both
    # draw the hidden masks alike and take the attention masks from the
    # counter hash, so they see the same masks
    ran = {}
    for use_kernel in (True, False):
        drop = trainer(use_kernel, TRAIN_DROPOUT)
        torch.cuda.synchronize()
        kern.reset_launches()
        loss, finite, grads = drop()
        torch.cuda.synchronize()
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"dropout train step (use_kernel={use_kernel}): loss "
              f"{float(loss)} or grads not finite")
        ran[use_kernel] = (float(loss), grads, dict(kern.LAUNCHES))
        del drop, grads
        torch.cuda.empty_cache()
    (loss_k, grads_k, counts), (loss_p, grads_p, counts_p) = ran[True], \
        ran[False]
    check_counts(counts, "dropout train step")
    check(sum(counts_p.values()) == 0, "the plain path launched kernels")
    for name, n in counts.items():
        launches[name] += n
    err = abs(loss_k - loss_p)
    g_err, g_leaf = grad_rel(torch, grads_k, grads_p)
    del ran, grads_k, grads_p
    check(loss_k != losses[0], "dropout left the step-0 loss unchanged")
    check(err <= TOL_TRAIN_LOSS, f"dropout train loss kernel vs plain "
                                 f"{err:.3g} > {TOL_TRAIN_LOSS}")
    check(g_err <= TOL_TRAIN_GRAD, f"dropout grads kernel vs plain: {g_leaf}"
                                   f" {g_err:.3g} > {TOL_TRAIN_GRAD}")
    print(f"train: dropout {TRAIN_DROPOUT} (hidden and attention), one step:"
          f" loss kernel path {loss_k:.6f}, plain path {loss_p:.6f}, |diff| "
          f"{err:.3g} (tol {TOL_TRAIN_LOSS}); grads, worst leaf {g_leaf}: "
          f"{g_err:.4g} (tol {TOL_TRAIN_GRAD}); launches {counts}")
    return launches


# examples/gpt_serve.py's default model and workload: hidden 64, 2 layers,
# 4 heads (head dim 16), vocab 512, positions = max_len 64, 2 slots,
# prefill window 16, 6 requests of its demo_requests() at max_new_tokens 8
SERVE_SMALL = dict(vocab_size=512, hidden_size=64, num_layers=2,
                   num_attention_heads=4, max_position_embeddings=64)
SERVE_SMALL_ENGINE = dict(max_seqs=2, max_len=64, prefill_len=16)
SERVE_SMALL_REQUESTS = 6
SERVE_SMALL_NEW = 8
# examples/gpt_pretrain.py's model on one device: hidden 32, 4 heads (head
# dim 8), 2 layers a stage x 2 stages, seq 16, vocab 128, micro-batch 2 x
# 4 micro-batches, Adam at lr 1e-3, 5 steps
TRAIN_SMALL = dict(vocab_size=128, hidden_size=32, num_layers=4,
                   num_attention_heads=4, max_position_embeddings=16)
TRAIN_SMALL_BATCH = (2 * 4, 16)
TRAIN_SMALL_STEPS = 5
TRAIN_SMALL_LR = 1e-3


def serve_small(torch, kern, card: str) -> dict:
    """``examples/gpt_serve.py``'s default model (head dim 16) through the
    port's ``ServingEngine`` and ``SlotScheduler`` with its demo requests:
    every request completes, ``flash_fwd`` runs once a layer a prefill and
    ``decode_attention`` once a layer a decode step; then teacher-forced
    logits, the kernel path against the plain path, within
    :data:`TOL_LOGITS`. Returns the run's launch counts."""
    import numpy as np
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.serving import Request, ServingEngine, SlotScheduler

    cfg = GPTConfig(**SERVE_SMALL)
    model = GPTModel(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))

    def engine(m):
        return ServingEngine(m, **SERVE_SMALL_ENGINE,
                             cache_dtype=torch.bfloat16, rng_seed=0,
                             device="cuda")

    rng = np.random.RandomState(0)
    window = SERVE_SMALL_ENGINE["prefill_len"]
    requests = [Request(prompt=rng.randint(1, cfg.vocab_size,
                                           size=1 + i % window).tolist(),
                        max_new_tokens=1 + SERVE_SMALL_NEW * (i + 1) // 2,
                        temperature=0.0 if i % 2 == 0 else 0.8)
                for i in range(SERVE_SMALL_REQUESTS)]
    sched = SlotScheduler(engine(model))
    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    done = sched.run(requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kern.LAUNCHES)
    L = cfg.num_layers
    check(len(done) == len(requests), f"small serving: {len(done)} of "
                                      f"{len(requests)} requests completed")
    for req, c in zip(requests, (done[k] for k in sorted(done))):
        check(len(c.tokens) == req.max_new_tokens
              and all(0 <= t < cfg.vocab_size for t in c.tokens),
              f"small serving: request {c.request_id} gave {len(c.tokens)}"
              " tokens or a token outside the vocab")
    check(launches["flash_fwd"] == L * len(requests)
          and launches["decode_attention"] == L * sched.steps,
          f"small serving: flash_fwd {launches['flash_fwd']} / "
          f"decode_attention {launches['decode_attention']} launches, not "
          f"{L} a prefill / a decode step")
    # teacher-forced: the kernel path against the plain path
    plain = GPTModel(dataclasses.replace(cfg, use_kernel=False),
                     device="cuda")
    plain.load_state_dict(model.state_dict())
    ek, ep = engine(model), engine(plain)
    toks = np.zeros(ek.max_seqs, np.int64)
    worst = 0.0
    for slot in range(ek.max_seqs):
        prompt = requests[slot].prompt
        lk, lp = ek.prefill_logits(prompt, slot), ep.prefill_logits(prompt,
                                                                    slot)
        check(bool(torch.isfinite(lk).all()), "small serving: prefill "
                                              "logits not finite")
        worst = max(worst, max_err(torch, lk, lp))
        toks[slot] = int(lk.argmax())
    for _ in range(SERVE_SMALL_NEW):
        lk, lp = ek.decode_logits(toks), ep.decode_logits(toks)
        check(bool(torch.isfinite(lk).all()), "small serving: decode "
                                              "logits not finite")
        worst = max(worst, max_err(torch, lk, lp))
        toks = lk.argmax(dim=-1).cpu().numpy()
    check(worst <= TOL_LOGITS, f"small serving: teacher-forced logits err "
                               f"{worst:.3g} > {TOL_LOGITS}")
    tokens = sum(len(c.tokens) for c in done.values())
    print(f"small serving (examples/gpt_serve.py's defaults: hidden 64, 2 "
          f"layers, 4 heads, head dim {cfg.head_dim} at body width "
          f"{kern.flash_width(cfg.head_dim)}, 2 slots): {len(done)} "
          f"requests, {sched.steps} decode steps, {tokens} tokens in "
          f"{wall:.3f} s; launches {launches}; teacher-forced logits kernel "
          f"vs plain (prefill + {SERVE_SMALL_NEW} decode steps) max_abs_err "
          f"{worst:.4g} (tol {TOL_LOGITS}) [{card}]")
    return launches


def train_small(torch, kern, card: str) -> dict:
    """``examples/gpt_pretrain.py``'s model at one device (head dim 8):
    :data:`TRAIN_SMALL_STEPS` steps of ``gpt_trainer`` (``FusedAdam``,
    the dynamic loss scale) on the kernels, each launching the three flash
    kernels once a layer, then the same steps on the plain path from the
    same weights, whose losses must agree within :data:`TOL_TRAIN_LOSS`.
    Returns the kernel path's launch counts."""
    import numpy as np
    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(**TRAIN_SMALL)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, TRAIN_SMALL_BATCH)).to("cuda")
    init = GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    losses = {}
    launches = {name: 0 for name in kern.LAUNCHES}
    for use_kernel in (True, False):
        step = gpt_trainer(torch, dataclasses.replace(cfg,
                                                      use_kernel=use_kernel),
                           init_state, tokens, TRAIN_SMALL_LR)
        run = []
        for i in range(TRAIN_SMALL_STEPS):
            kern.reset_launches()
            loss, finite, _ = step()
            torch.cuda.synchronize()
            check(bool(finite) and bool(torch.isfinite(loss)),
                  f"small training step {i} (use_kernel={use_kernel}): loss "
                  "or grads not finite")
            run.append(float(loss))
            counts = dict(kern.LAUNCHES)
            if use_kernel:
                for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                    check(counts[name] == cfg.num_layers,
                          f"small training step {i}: {name} launched "
                          f"{counts[name]} times, not {cfg.num_layers}")
                for name, n in counts.items():
                    launches[name] += n
            else:
                check(sum(counts.values()) == 0,
                      "small training: the plain path launched kernels")
        losses[use_kernel] = run
    err = max(abs(a - b) for a, b in zip(losses[True], losses[False]))
    check(err <= TOL_TRAIN_LOSS, f"small training: losses kernel vs plain "
                                 f"{err:.3g} > {TOL_TRAIN_LOSS}")
    print(f"small training (examples/gpt_pretrain.py's model at one device: "
          f"hidden 32, 4 layers, 4 heads, head dim {cfg.head_dim} at body "
          f"width {kern.flash_width(cfg.head_dim)}, batch "
          f"{TRAIN_SMALL_BATCH[0]} x seq {TRAIN_SMALL_BATCH[1]}, FusedAdam lr "
          f"{TRAIN_SMALL_LR}): losses kernel path "
          f"{[f'{x:.6f}' for x in losses[True]]}, plain path "
          f"{[f'{x:.6f}' for x in losses[False]]}, max |diff| {err:.3g} (tol "
          f"{TOL_TRAIN_LOSS}); launches {launches} [{card}]")
    return launches


# bench.py::bench_gpt_remat's legs on the port: GPT-small at batch 8 x
# 1024 tokens, bf16, each policy from the same weights
REMAT_LEGS = ("none", "selective", "full", "offload")
REMAT_STEPS = 4          # a warm step, then the timed ones
REMAT_COMPARE_STEPS = 3  # losses compared over these, grads at step 0
GEMM_OPS = ("aten.mm.", "aten.addmm.", "aten.bmm.")


def _gemm_counter(torch):
    """A ``TorchDispatchMode`` that counts the GEMM ops run under it."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Gemms(TorchDispatchMode):
        count = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if str(func).startswith(GEMM_OPS):
                self.count += 1
            return func(*args, **(kwargs or {}))
    return Gemms()


def train_remat(torch, kern, card: str) -> dict:
    """``bench.py::bench_gpt_remat``'s four legs (``none``, ``selective``,
    ``full``, ``offload``) on the port's GPT-small training step, each from
    the same weights: the median step after a warm one, tokens/s, the peak
    memory over a step, the kernels' launches and the GEMMs a step (the
    warm step, counted with a ``TorchDispatchMode``), and for ``offload``
    its host copies a step. Every policy's losses over
    :data:`REMAT_COMPARE_STEPS` steps and step 0's grads must equal
    ``none``'s bit for bit (limit 0); peak memory must order ``none >
    selective > full``; ``flash_fwd`` must launch 12 times a step under
    ``none``, ``selective`` and ``offload`` and 24 under ``full``; no GEMM
    may run again under ``selective`` or ``offload``. Then one step with
    hidden and attention dropout 0.1 under ``full`` and ``selective``
    against ``none``'s, bit for bit, from one generator seed, which each
    leaves where ``none`` does. Returns the launch counts of all legs."""
    import numpy as np
    from apex_tpu_torch import remat
    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(vocab_size=32768, hidden_size=768, num_layers=12,
                    num_attention_heads=12, max_position_embeddings=1024)
    batch, seq = TRAIN_BH[0], TRAIN_ATTN[1]
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    init = GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    L = cfg.num_layers
    launches = {name: 0 for name in kern.LAUNCHES}
    legs = {}
    for mode in REMAT_LEGS:
        step = gpt_trainer(torch, dataclasses.replace(cfg, remat_policy=mode),
                           init_state, tokens, 1e-4)
        losses, times = [], []
        for i in range(REMAT_STEPS):
            torch.cuda.synchronize()
            kern.reset_launches()
            torch.cuda.reset_peak_memory_stats()
            copies = dict(remat.HOST_COPIES)
            t0 = time.perf_counter()
            if i == 0:
                with _gemm_counter(torch) as gemms:
                    loss, finite, grads = step()
            else:
                loss, finite, grads = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(bool(finite) and bool(torch.isfinite(loss)),
                  f"remat {mode} step {i}: loss or grads not finite")
            counts = dict(kern.LAUNCHES)
            for name, n in counts.items():
                launches[name] += n
            losses.append(loss)
            if i == 0:
                # on the host, so that no leg's peak holds another's grads
                grads0 = {n: g.detach().cpu() for n, g in grads.items()}
                first = (counts, gemms.count,
                         {k: remat.HOST_COPIES[k] - copies[k]
                          for k in copies})
            elif i == 1:
                peak = torch.cuda.max_memory_allocated()
            del grads
        steady = sorted(times[1:])[len(times[1:]) // 2]
        counts, n_gemm, host = first
        legs[mode] = dict(losses=losses, grads0=grads0, ms=1e3 * steady,
                          peak=peak, counts=counts, gemms=n_gemm, host=host)
        print(f"remat {mode}: GPT-small ({batch} x {seq} tokens, bf16), "
              f"median step {1e3 * steady:.3f} ms after a warm step "
              f"({1e3 * times[0]:.3f} ms, counted), {batch * seq / steady:.1f}"
              f" tokens/s, peak memory {peak / 2 ** 30:.3f} GiB ({peak} B), "
              f"launches a step {counts}, GEMMs a step {n_gemm}"
              + (f", host copies a step {host}" if mode == "offload" else "")
              + f"; losses {[f'{float(x):.6f}' for x in losses]} [{card}]",
              flush=True)
        del step
        torch.cuda.empty_cache()
    base = legs["none"]
    for mode in REMAT_LEGS:
        leg = legs[mode]
        check(leg["counts"]["flash_fwd"] == (2 * L if mode == "full" else L),
              f"remat {mode}: flash_fwd launched {leg['counts']['flash_fwd']}"
              f" times a step")
        for name in ("flash_bwd_dq", "flash_bwd_dkv"):
            check(leg["counts"][name] == L, f"remat {mode}: {name} launched "
                                            f"{leg['counts'][name]} times")
        if mode in ("selective", "offload"):
            check(leg["gemms"] == base["gemms"],
                  f"remat {mode}: {leg['gemms']} GEMMs a step, none runs "
                  f"{base['gemms']}: a GEMM ran again")
        if mode == "none":
            continue
        same = all(torch.equal(a, b) for a, b in
                   zip(leg["losses"][:REMAT_COMPARE_STEPS],
                       base["losses"][:REMAT_COMPARE_STEPS]))
        diff = max(abs(float(a) - float(b)) for a, b in
                   zip(leg["losses"], base["losses"]))
        g_err, g_leaf = grad_rel(torch, leg["grads0"], base["grads0"])
        g_same = all(torch.equal(leg["grads0"][n], g)
                     for n, g in base["grads0"].items())
        print(f"remat {mode} vs none: losses over {REMAT_COMPARE_STEPS} steps"
              f" max |diff| {diff:.3g}, step-0 grads worst leaf {g_leaf} "
              f"{g_err:.3g} (limit 0: bit for bit), equal bit for bit: "
              f"{same and g_same}; {leg['gemms'] - base['gemms']} GEMMs run "
              f"again a step")
        check(same and g_same, f"remat {mode}: losses or step-0 grads differ "
                               f"from none's")
    peaks = {m: legs[m]["peak"] for m in REMAT_LEGS}
    check(peaks["none"] > peaks["selective"] > peaks["full"],
          f"remat: peak memory does not order none > selective > full: "
          f"{peaks}")
    print("remat: peak memory orders none > selective > full: " + ", ".join(
        f"{m} {p / 2 ** 30:.3f} GiB" for m, p in peaks.items()) + f" [{card}]")
    del legs, base
    torch.cuda.empty_cache()

    # dropout under recompute: the same masks as none from one seed
    ran = {}
    for mode in ("none", "full", "selective"):
        step = gpt_trainer(torch, dataclasses.replace(
            cfg, remat_policy=mode, hidden_dropout=TRAIN_DROPOUT,
            attention_dropout=TRAIN_DROPOUT), init_state, tokens, 1e-4)
        kern.reset_launches()
        loss, finite, grads = step()
        torch.cuda.synchronize()
        for name, n in kern.LAUNCHES.items():
            launches[name] += n
        check(bool(finite), f"remat {mode} with dropout: grads not finite")
        ran[mode] = (loss, {n: g.detach().cpu() for n, g in grads.items()},
                     step.generator.get_state())
        del step, grads
        torch.cuda.empty_cache()
    for mode in ("full", "selective"):
        loss, grads, state = ran[mode]
        same = (torch.equal(loss, ran["none"][0])
                and all(torch.equal(grads[n], g)
                        for n, g in ran["none"][1].items())
                and torch.equal(state, ran["none"][2]))
        check(same, f"remat {mode} with dropout {TRAIN_DROPOUT}: the loss, "
                    "grads or the generator's state differ from none's")
    print(f"remat with hidden and attention dropout {TRAIN_DROPOUT}: full and"
          f" selective equal none bit for bit (loss "
          f"{float(ran['none'][0]):.6f}, every grad, the generator's state "
          f"after the step)")
    return launches


# TrainConfig on the card: GPT-small at train's shape built through the
# config (O2: fp32 params, bf16 compute; adam at lr 1e-4 with FusedAdam's
# betas and eps and no weight decay), the explicit DynamicLossScale(2**12)
CONFIG_STEPS = 3
# optim/grad_norm against torch.linalg.vector_norm over the unscaled grads:
# two fp32 reductions of the same squares in other orders
TOL_GRAD_NORM = 1e-6


def train_config(torch, kern, card: str) -> dict:
    """The rest of one-device training on the card: GPT-small built by
    ``TrainConfig`` (``opt_level="O2"``, ``OptimizerConfig(name="adam",
    lr=1e-4, weight_decay=0.0)``; the built model's config and optimizer's
    hyperparameters must equal ``train``'s), :data:`CONFIG_STEPS` steps
    through ``scaled_value_and_grad`` and ``OptimizerBase.step`` under
    ``ingraph.reap``, each launching the three flash kernels 12 times and
    both LayerNorm kernels 25 times. Against the hand-assembled trainer of
    ``train`` (``gpt_trainer``) from the same weights: the losses and step
    0's grads within ``TOL_TRAIN_*``; ``amp/loss_scale`` equal to the new
    state's scale, ``amp/overflow_count`` 0, ``optim/grad_norm`` within
    :data:`TOL_GRAD_NORM` of ``torch.linalg.vector_norm`` over the
    unscaled grads; and with no collector open, one step's launches and
    host copies (``step_counts``, the most of ``HOST_COST_WINDOWS``
    windows) equal to the hand-assembled step's. Returns the config
    steps' launch counts."""
    import numpy as np
    from apex_tpu_torch.amp import DynamicLossScale, scaled_value_and_grad
    from apex_tpu_torch.config import ModelConfig, OptimizerConfig, TrainConfig
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.observability import ingraph
    from apex_tpu_torch.optimizers import FusedAdam

    sizes = dict(vocab_size=32768, hidden_size=768, num_layers=12,
                 num_attention_heads=12, max_position_embeddings=1024)
    cfg = GPTConfig(**sizes)                       # train's model
    tc = TrainConfig(model=ModelConfig(name="gpt", **sizes),
                     optimizer=OptimizerConfig(name="adam", lr=1e-4,
                                               weight_decay=0.0),
                     opt_level="O2")
    batch, seq = TRAIN_BH[0], TRAIN_ATTN[1]
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    init = GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init

    def most(fn):
        windows = [step_totals(step_counts(torch, fn))
                   for _ in range(HOST_COST_WINDOWS)]
        return tuple(max(col) for col in zip(*windows)), windows

    # the hand-assembled step of ``train``
    hand = gpt_trainer(torch, cfg, init_state, tokens, 1e-4)
    hand_losses = []
    for i in range(CONFIG_STEPS):
        loss, finite, grads = hand()
        check(bool(finite), f"train_config hand step {i}: grads not finite")
        hand_losses.append(float(loss))
        if i == 0:
            hand_grads0 = {n: g.clone() for n, g in grads.items()}
        del grads
    hand_cost, hand_windows = most(hand)
    del hand
    torch.cuda.empty_cache()

    model = tc.build_model(device="cuda")
    check(model.cfg == cfg, f"train_config: built {model.cfg}, not {cfg}")
    model.load_state_dict(init_state)
    opt = tc.build_optimizer()
    ref = FusedAdam(lr=1e-4)
    check(isinstance(opt, FusedAdam) and (opt.lr, opt.beta1, opt.beta2,
                                          opt.eps, opt.weight_decay) ==
          (ref.lr, ref.beta1, ref.beta2, ref.eps, ref.weight_decay),
          "train_config: the built optimizer is not train's FusedAdam")
    params = dict(model.named_parameters())
    opt_state = opt.init(params)
    scaler = DynamicLossScale(init_scale=2.0 ** 12)
    carry = {"ls": scaler.init(device="cuda")}
    grad_fn = scaled_value_and_grad(lambda p, t: model.loss(t, t), scaler)

    def step():
        value, _, grads, finite, carry["ls"] = grad_fn(carry["ls"], params,
                                                       tokens)
        opt.step(grads, opt_state, params, grads_finite=finite)
        return value, finite, grads

    reaped = ingraph.reap(step)
    torch.cuda.synchronize()
    kern.reset_launches()
    losses, worst_norm = [], 0.0
    for i in range(CONFIG_STEPS):
        (loss, finite, grads), metrics = reaped()
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"train_config step {i}: loss {float(loss)} or grads not "
              "finite")
        got = metrics.as_floats()
        norm = float(torch.linalg.vector_norm(torch.cat(
            [g.reshape(-1) for g in grads.values()])))
        rel = abs(got["optim/grad_norm"] / norm - 1)
        worst_norm = max(worst_norm, rel)
        check(got["amp/loss_scale"] == float(carry["ls"].loss_scale)
              and got["amp/overflow_count"] == 0.0
              and got["amp/skipped_steps"] == 0.0,
              f"train_config step {i}: metrics {got}, scale "
              f"{float(carry['ls'].loss_scale)}")
        check(rel <= TOL_GRAD_NORM, f"train_config step {i}: optim/grad_norm"
              f" {got['optim/grad_norm']} against vector_norm {norm}: "
              f"{rel:.3g} > {TOL_GRAD_NORM}")
        losses.append(float(loss))
        if i == 0:
            g_err, g_leaf = grad_rel(torch, grads, hand_grads0)
            metrics0 = got
        del grads
    torch.cuda.synchronize()
    launches = dict(kern.LAUNCHES)
    L = cfg.num_layers
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == CONFIG_STEPS * L,
              f"train_config: {name} launched {launches[name]} times, not "
              f"{CONFIG_STEPS * L}")
    for name in ("ln_fwd", "ln_bwd"):
        check(launches[name] == CONFIG_STEPS * LN_PER_GPT_PASS,
              f"train_config: {name} launched {launches[name]} times, not "
              f"{CONFIG_STEPS * LN_PER_GPT_PASS}")
    loss_err = max(abs(a - b) for a, b in zip(losses, hand_losses))
    check(loss_err <= TOL_TRAIN_LOSS, f"train_config losses vs the hand "
                                      f"step {loss_err:.3g} > {TOL_TRAIN_LOSS}")
    check(g_err <= TOL_TRAIN_GRAD, f"train_config step 0 grads vs the hand "
                                   f"step: {g_leaf} {g_err:.3g} > "
                                   f"{TOL_TRAIN_GRAD}")
    cost, windows = most(step)
    check(cost == hand_cost, f"train_config: a step with no collector "
                             f"makes {cost} (launches, DtoH, HtoD), the "
                             f"hand-assembled step {hand_cost}")
    print(f"train_config: GPT-small through TrainConfig (O2, adam lr 1e-4), "
          f"{CONFIG_STEPS} steps of scaled_value_and_grad + "
          f"OptimizerBase.step under ingraph.reap: losses "
          f"{[f'{x:.6f}' for x in losses]}, the hand-assembled step's "
          f"{[f'{x:.6f}' for x in hand_losses]}, max |diff| {loss_err:.3g} "
          f"(tol {TOL_TRAIN_LOSS}); step 0's grads, worst leaf {g_leaf}: "
          f"{g_err:.4g} (tol {TOL_TRAIN_GRAD}); step 0's metrics {metrics0}, "
          f"optim/grad_norm against vector_norm: worst {worst_norm:.3g} (tol "
          f"{TOL_GRAD_NORM}); launches {launches} [{card}]")
    print(f"train_config: one step with no collector open, (launches, DtoH "
          f"copies, HtoD copies) the most of {HOST_COST_WINDOWS} windows: "
          f"{cost}, the hand-assembled step {hand_cost}; every window "
          f"{windows}, hand {hand_windows} [{card}]")
    del model, opt, opt_state, params, reaped
    torch.cuda.empty_cache()
    return launches


# bench.py::bench_headline on the port: ResNet-50 (1000 classes), 256
# images of 224 x 224 x 3 in bf16 from RandomState(0) and their labels,
# bf16 compute with fp32 params,
# FlatOptimizer(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)),
# DynamicLossScale(2**12), the unscale fused into the update
HEADLINE_BATCH = 256
HEADLINE_IMG = 224
HEADLINE_WARMUP = 5
HEADLINE_STEPS = 20
# the reference's analytic figure: 4.1 GMACs an image forward, x3 for
# forward and backward (bench.py:320)
HEADLINE_FLOPS = 3 * 2 * 4.1e9 * HEADLINE_BATCH
HEADLINE_O0_STEPS = 2
# the small configuration, on the card and on the CPU from one state dict
RESNET_SMALL = dict(num_classes=10, stage_sizes=(1, 1, 1, 1), width=8)
RESNET_SMALL_BATCH = (8, 32)       # images, side
RESNET_SMALL_STEPS = 3
# the small configuration's losses, card against CPU, fp32 (TF32 off):
# cuDNN's and the CPU's conv algorithms sum in other orders
TOL_RESNET_SMALL_LOSS = 1e-4
# the fp32 (O0) leg against the bf16 leg at step 0, from one state dict.
# At this random init the bf16 body's grads are dominated by rounding in
# the JAX package too (its bf16 grads lie ~1.3 of the fp32 grads' norm
# from them; tests/test_torch_resnet.py holds the port's gap to the
# reference's): the loss within TOL_O0_LOSS, the grads as one vector
# within TOL_O0_GRAD (a lost or doubled unscale reads past it), and the
# head's bias, the mean of softmax - onehot over the batch, within
# TOL_O0_HEAD (0.003 on the CPU at 16 x 96 x 96): the sharp check that
# the scale was applied and taken off
TOL_O0_LOSS = 0.25
TOL_O0_GRAD = 2.0
TOL_O0_HEAD = 0.05


def resnet_trainer(torch, cfg, init_state: dict, x, labels, device: str):
    """A step function of ``bench.py::bench_headline``'s step on a
    ``ResNet50(cfg)`` on ``device`` loaded from ``init_state``: the
    softmax cross-entropy of the logits, backward of the loss times the
    scale, ``all_finite`` of the scaled grads, ``DynamicLossScale.update``
    (init 2**12) and ``FlatOptimizer(FusedSGD(lr=0.1, momentum=0.9,
    weight_decay=1e-4)).step(..., scale=1 / loss_scale)``. The step returns
    ``(loss, finite, scaled grads, the scale they carry)``."""
    import torch.nn.functional as F
    from apex_tpu_torch.amp import DynamicLossScale, all_finite
    from apex_tpu_torch.models import ResNet50
    from apex_tpu_torch.optimizers import FlatOptimizer, FusedSGD

    model = ResNet50(cfg, device=device)
    model.load_state_dict(init_state)
    params = dict(model.named_parameters())
    opt = FlatOptimizer(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))
    opt_state = opt.init(params)
    scaler = DynamicLossScale(init_scale=2.0 ** 12)
    carry = {"ls": scaler.init(device=device)}

    def step():
        ls = carry["ls"]
        for p in params.values():
            p.grad = None
        loss = F.cross_entropy(model(x), labels)
        (loss * ls.loss_scale).backward()
        grads = {n: p.grad for n, p in params.items()}
        finite = all_finite(grads)
        carry["ls"] = scaler.update(ls, finite)
        opt.step(grads, opt_state, params, grads_finite=finite,
                 scale=1.0 / ls.loss_scale)
        return loss.detach(), finite, grads, ls.loss_scale

    step.carry = carry
    step.model = model
    return step


def expected_scales(flags, scale: float, unskipped: int = 0,
                    interval: int = 2000) -> tuple:
    """``DynamicLossScale``'s rule (init 2**12, growth 2 every
    ``interval`` clean steps, halving on overflow, within [1, 2**24]) over
    a run's finite flags: the scale each step used, and the final
    ``(scale, unskipped)``."""
    used = []
    for finite in flags:
        used.append(scale)
        if finite:
            unskipped += 1
            if unskipped >= interval:
                scale, unskipped = min(scale * 2, 2.0 ** 24), 0
        else:
            scale, unskipped = max(scale / 2, 1.0), 0
    return used, (scale, unskipped)


def train_resnet(torch, kern, card: str) -> dict:
    """``bench.py::bench_headline``'s step on the port at its full shape
    (:data:`HEADLINE_BATCH` x 224 x 224 x 3 bf16, 1000 classes, bf16
    compute): :data:`HEADLINE_WARMUP` warm-up and :data:`HEADLINE_STEPS`
    timed steps (host clock around each synchronized step), images/s, the
    peak memory, the share of the bf16 dense peak for the reference's
    analytic FLOPs, a profile of one step; every loss finite and the scale
    state as ``DynamicLossScale`` moves it over the run's finite flags; no
    kernel of the port launched (convs and BN are cuDNN and torch ops, as
    they are XLA's in the reference). Then an fp32 (O0) leg of
    :data:`HEADLINE_O0_STEPS` steps from the same weights (``TOL_O0_*``
    at step 0), and the small configuration on the card against the same
    steps on the CPU (:data:`TOL_RESNET_SMALL_LOSS`). Returns the launch
    counts (all 0)."""
    import numpy as np
    from apex_tpu_torch.models import ResNet50, ResNetConfig

    cfg = ResNetConfig(num_classes=1000, compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(HEADLINE_BATCH, HEADLINE_IMG,
                                   HEADLINE_IMG, 3).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    labels = torch.from_numpy(rng.randint(0, 1000, HEADLINE_BATCH)).to(
        "cuda")
    init = ResNet50(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kern.reset_launches()
    step = resnet_trainer(torch, cfg, init_state, x, labels, "cuda")
    losses, flags, times = [], [], []
    for i in range(HEADLINE_WARMUP + HEADLINE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, finite, grads, scale = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss)
        flags.append(finite)
        if i == 0:
            grads0 = {n: g.float() / scale for n, g in grads.items()}
            used0 = float(scale)
        del grads
    peak = torch.cuda.max_memory_allocated()
    launches = dict(kern.LAUNCHES)
    losses = [float(v) for v in losses]
    flags = [bool(f) for f in flags]
    check(all(np.isfinite(losses)), f"train_resnet: losses {losses}")
    used, (scale, unskipped) = expected_scales(flags, 2.0 ** 12)
    ls = step.carry["ls"]
    check(used0 == used[0] and float(ls.loss_scale) == scale
          and int(ls.unskipped) == unskipped,
          f"train_resnet: the scale state {float(ls.loss_scale)}, "
          f"{int(ls.unskipped)} after finite flags {flags}, not {scale}, "
          f"{unskipped}")
    check(sum(launches.values()) == 0,
          f"train_resnet launched the port's kernels: {launches}")
    timed = sorted(times[HEADLINE_WARMUP:])
    step_s = timed[len(timed) // 2]
    mean_s = sum(timed) / len(timed)
    print(f"train_resnet: ResNet-50 (bench_headline: batch {HEADLINE_BATCH} "
          f"x {HEADLINE_IMG} x {HEADLINE_IMG} x 3 bf16, 1000 classes, bf16 "
          f"compute, fp32 params; FlatOptimizer(FusedSGD(0.1, 0.9, 1e-4)), "
          f"DynamicLossScale(2**12), the unscale in the update): "
          f"{HEADLINE_STEPS} timed steps after {HEADLINE_WARMUP}, median step "
          f"{1e3 * step_s:.3f} ms, mean {1e3 * mean_s:.3f} ms, min "
          f"{1e3 * timed[0]:.3f}, max {1e3 * timed[-1]:.3f} (host clock, "
          f"synchronized), first step {1e3 * times[0]:.3f} ms; "
          f"{HEADLINE_BATCH / step_s:.1f} imgs/s; peak memory "
          f"{peak / 2 ** 30:.3f} GiB; {HEADLINE_FLOPS / step_s / 1e12:.1f} "
          f"TFLOP/s for the reference's analytic {HEADLINE_FLOPS:.4g} FLOPs "
          f"a step = {100 * HEADLINE_FLOPS / step_s / BF16_OPS_PER_S:.2f}% "
          f"of the bf16 dense peak; losses {[f'{v:.4f}' for v in losses]}; "
          f"finite {sum(flags)}/{len(flags)}, scale {scale:g}; launches of "
          f"the port's kernels {sum(launches.values())} [{card}]")
    profile_step(torch, f"train_resnet step ({HEADLINE_BATCH} x "
                        f"{HEADLINE_IMG}^2, bf16)", step, card, iters=1,
                 top=12)
    del step
    torch.cuda.empty_cache()

    # the fp32 leg from the same weights
    step = resnet_trainer(torch, dataclasses.replace(
        cfg, compute_dtype=torch.float32), init_state, x, labels, "cuda")
    for i in range(HEADLINE_O0_STEPS):
        loss, finite, grads, scale = step()
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"train_resnet O0 step {i}: loss {float(loss)} or grads not "
              "finite")
        if i == 0:
            loss32 = float(loss)
            g32 = {n: g / scale for n, g in grads.items()}
        del grads
    del step
    diff2 = sum(float((grads0[n] - g).pow(2).sum()) for n, g in g32.items())
    norm2 = sum(float(g.pow(2).sum()) for g in g32.values())
    g_rel = (diff2 / norm2) ** 0.5
    head = float((grads0["fc.bias"] - g32["fc.bias"]).norm()
                 / g32["fc.bias"].norm())
    leaf_err, leaf = grad_rel(torch, grads0, g32)
    head_w, _ = grad_rel(torch, {"w": grads0["fc.weight"]},
                         {"w": g32["fc.weight"]})
    loss_err = abs(loss32 - losses[0])
    print(f"train_resnet: O0 (fp32 compute) against bf16 at step 0 from one "
          f"state dict: loss {loss32:.6f} vs {losses[0]:.6f}, |diff| "
          f"{loss_err:.4g} (tol {TOL_O0_LOSS}); grads as one vector "
          f"||bf16 - fp32|| / ||fp32|| {g_rel:.4f} (tol {TOL_O0_GRAD}); head "
          f"bias {head:.4g} (tol {TOL_O0_HEAD}), head weight {head_w:.4g}; "
          f"worst leaf {leaf} {leaf_err:.4g} [{card}]")
    check(loss_err <= TOL_O0_LOSS, f"train_resnet O0 loss {loss32} vs bf16 "
                                   f"{losses[0]}: {loss_err:.3g}")
    check(g_rel <= TOL_O0_GRAD, f"train_resnet O0 grads vs bf16: "
                                f"{g_rel:.3g} > {TOL_O0_GRAD}")
    check(head <= TOL_O0_HEAD, f"train_resnet O0 head bias grad vs bf16: "
                               f"{head:.3g} > {TOL_O0_HEAD}")
    del grads0, g32, x, labels, init_state
    torch.cuda.empty_cache()

    # the small configuration on the card and on the CPU
    small = ResNetConfig(compute_dtype=torch.float32, **RESNET_SMALL)
    n, side = RESNET_SMALL_BATCH
    rng = np.random.RandomState(1)
    xs = torch.from_numpy(rng.randn(n, side, side, 3).astype(np.float32))
    ys = torch.from_numpy(rng.randint(0, RESNET_SMALL["num_classes"], n))
    state = ResNet50(small, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    runs = []
    for device in ("cuda", "cpu"):
        step = resnet_trainer(torch, small, {k: v.to(device) for k, v in
                                             state.items()},
                              xs.to(device), ys.to(device), device)
        runs.append([float(step()[0]) for _ in range(RESNET_SMALL_STEPS)])
        del step
    on_card, on_cpu = runs
    err = max(abs(a - b) for a, b in zip(on_card, on_cpu))
    check(err <= TOL_RESNET_SMALL_LOSS, f"train_resnet small: card losses "
                                        f"{on_card} vs CPU {on_cpu}")
    check(sum(kern.LAUNCHES.values()) == 0,
          "train_resnet launched the port's kernels")
    print(f"train_resnet: small configuration (stages (1, 1, 1, 1), width 8, "
          f"{n} x {side} x {side}, fp32, {RESNET_SMALL_STEPS} steps): losses "
          f"card {[f'{v:.6f}' for v in on_card]}, CPU "
          f"{[f'{v:.6f}' for v in on_cpu]}, max |diff| {err:.3g} (tol "
          f"{TOL_RESNET_SMALL_LOSS}) [{card}]")
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 7: BERT-base pretraining
# ---------------------------------------------------------------------------

def bert_batch(torch, cfg):
    """BERT's pretraining batch from ``np.random.RandomState(0)``: 16
    sequences of 512 positions, each row's length drawn in 256-512 (the
    attention mask 0 past it), token types 0 up to a drawn split point and
    1 after it, tokens and MLM labels over the vocab, a Bernoulli 0.15 loss
    mask over the real tokens, and 0/1 sentence-order labels."""
    import numpy as np
    rng = np.random.RandomState(0)
    b, s = BERT_BH[0], BERT_ATTN[1]
    lengths = rng.randint(BERT_LENGTHS[0], BERT_LENGTHS[1] + 1, b)
    pos = np.arange(s)[None, :]
    mask = (pos < lengths[:, None]).astype(np.int64)
    split = rng.randint(1, lengths)
    types = (pos >= split[:, None]).astype(np.int64) * mask
    tokens = rng.randint(0, cfg.vocab_size, (b, s))
    labels = rng.randint(0, cfg.vocab_size, (b, s))
    loss_mask = ((rng.rand(b, s) < 0.15) & (mask > 0)).astype(np.float32)
    binary = rng.randint(0, 2, b)
    batch = dict(tokens=tokens, lm_labels=labels, loss_mask=loss_mask,
                 token_types=types, attention_mask=mask,
                 binary_labels=binary)
    return {k: torch.from_numpy(v).to("cuda") for k, v in batch.items()}


def bert_base(torch):
    """BERT-base's config (google-research/bert ``uncased_L-12_H-768_A-12``:
    vocab 30522, hidden 768, 12 layers, 12 heads, ffn 3072, 512 positions,
    2 token types, eps 1e-12, the pooler and the sentence-order head)."""
    from apex_tpu_torch.models import BertConfig
    return BertConfig(vocab_size=30522, hidden_size=768, num_layers=12,
                      num_attention_heads=12, ffn_hidden_size=3072,
                      max_position_embeddings=512, num_token_types=2,
                      layernorm_epsilon=1e-12, add_pooler=True,
                      add_binary_head=True)


def bert_launches(L: int) -> dict:
    """The port's kernel launches of one BERT training step: each flash
    kernel once a layer (non-causal, the padding bias), each LayerNorm
    kernel 26 times, nothing else."""
    return {"flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
            "flash_dbias": 0, "flash_dbias_fold": 0,
            "ln_fwd": LN_PER_BERT_PASS, "ln_bwd": LN_PER_BERT_PASS,
            "decode_attention": 0, "paged_decode_attention": 0}


def train_bert(torch, kern, card: str):
    """BERT-base pretraining steps at full width (see the constants):
    ``BertModel.loss`` with every head, backward of the scaled loss,
    unscale, ``all_finite``, ``DynamicLossScale.update``, ``FusedAdam.step``
    with the skip, no dropout. Each step must launch each flash kernel once
    per layer (non-causal, with the padding bias) and each LayerNorm kernel
    26 times; then the plain path from the same state dict must launch
    nothing and agree on the losses and step 0's grads. Returns the launch
    counts of the kernel path's steps."""
    from apex_tpu_torch.amp import DynamicLossScale, all_finite
    from apex_tpu_torch.models import BertModel
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = bert_base(torch)
    batch = bert_batch(torch, cfg)
    real = int(batch["attention_mask"].sum())
    init = BertModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init

    def trainer(use_kernel: bool):
        model = BertModel(dataclasses.replace(cfg, use_kernel=use_kernel),
                          device="cuda")
        model.load_state_dict(init_state)
        params = dict(model.named_parameters())
        opt = FusedAdam(lr=1e-4)
        opt_state = opt.init(params)
        scaler = DynamicLossScale(init_scale=2.0 ** 12)
        carry = {"ls": scaler.init(device="cuda")}

        def step():
            ls = carry["ls"]
            for p in params.values():
                p.grad = None
            loss = model.loss(**batch)
            (loss * ls.loss_scale).backward()
            grads = scaler.unscale(ls, {n: p.grad for n, p in params.items()})
            finite = all_finite(grads)
            carry["ls"] = scaler.update(ls, finite)
            opt.step(grads, opt_state, params, grads_finite=finite)
            return loss.detach(), finite, grads

        return step

    want = bert_launches(cfg.num_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step = trainer(True)
    launches = {name: 0 for name in kern.LAUNCHES}
    losses, times = [], []
    for i in range(BERT_STEPS):
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        loss, finite, grads = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(kern.LAUNCHES)
        check(counts == want, f"BERT step {i}: launches {counts}, want "
                              f"{want}")
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"BERT step {i}: loss {float(loss)} or grads not finite")
        for name, n in counts.items():
            launches[name] += n
        losses.append(float(loss))
        if i == 0:
            grads0 = grads
        del grads
        print(f"bert step {i}: loss {losses[-1]:.6f}, {1e3 * times[-1]:.3f} "
              f"ms (host clock, synchronized), launches {counts} [{card}]")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_n = BERT_BH[0] * BERT_ATTN[1]
    print(f"bert: BERT-base (batch {BERT_BH[0]} x seq {BERT_ATTN[1]}, "
          f"{real} real tokens, bf16 compute, fp32 params), median step "
          f"{1e3 * steady:.3f} ms after the first ({1e3 * times[0]:.3f} ms), "
          f"{tokens_n / steady:.1f} tokens/s ({real / steady:.1f} real), "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB [{card}]")
    profile_step(torch, "BERT train step (16 x 512 tokens)", step, card,
                 iters=2, top=12)
    del step
    torch.cuda.empty_cache()

    plain = trainer(False)
    kern.reset_launches()
    diffs = []
    for i in range(BERT_COMPARE_STEPS):
        loss, finite, grads = plain()
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"plain BERT step {i}: loss or grads not finite")
        diffs.append(abs(float(loss) - losses[i]))
        print(f"bert step {i}: plain-path loss {float(loss):.6f}, kernel "
              f"path {losses[i]:.6f}, |diff| {diffs[-1]:.3g}")
        if i == 0:
            g_err, g_leaf = grad_rel(torch, grads0, grads)
        del grads
    del plain, grads0
    torch.cuda.empty_cache()
    check(sum(kern.LAUNCHES.values()) == 0,
          "the plain BERT path launched kernels")
    for i, err in enumerate(diffs):
        tol = TOL_BERT_LOSS[min(i, 1)]
        check(err <= tol, f"BERT step {i} loss kernel vs plain {err:.3g} > "
                          f"{tol}")
    check(g_err <= TOL_BERT_GRAD, f"BERT step 0 grads kernel vs plain: "
                                  f"{g_leaf} {g_err:.3g} > {TOL_BERT_GRAD}")
    print(f"bert: losses kernel path vs plain path over "
          f"{BERT_COMPARE_STEPS} steps: |diff| "
          f"{', '.join(f'{e:.4g}' for e in diffs)} (tol {TOL_BERT_LOSS[0]} "
          f"at step 0, {TOL_BERT_LOSS[1]} after); step 0's unscaled grads, "
          f"worst leaf {g_leaf}: ||kernel - plain|| / ||plain|| {g_err:.4g} "
          f"(tol {TOL_BERT_GRAD})")
    return launches


# ---------------------------------------------------------------------------
# phase 7 (cont.): the rest of the fused optimizers and the Transformer ops
# ---------------------------------------------------------------------------

# NVIDIA's BERT phase-1 LAMB (DeepLearningExamples, run_pretraining.py):
# lr 6e-3 (held constant here), betas (0.9, 0.999), eps 1e-6, weight
# decay 0.01, max grad norm 1.0 (FusedLAMB's default)
LAMB = dict(lr=6e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01)
LAMB_STEPS = 4
# a LAMB step on the card against the same step on the CPU from the same
# grads, params and state: the elementwise arithmetic rounds alike (IEEE
# sqrt and division on both), the norms (the clip's, the trust ratios')
# sum in other orders (~1e-7 of a norm), so each leaf lands within ~1e-6
# of its largest magnitude; the limit, of each leaf's max |CPU|
TOL_LAMB_STEP = 1e-5
# FusedMixedPrecisionLamb's masters fed scaled grads and the live (power
# of two) scale, against FusedLAMB on fp32 copies fed the unscaled grads:
# the same products on the same card, so equal; the limit, as above
TOL_MP_LAMB = 1e-6


def leaf_err(torch, got: dict, want: dict) -> tuple:
    """The worst leaf's ``max |got - want| / max |want|`` over two name ->
    tensor maps (any devices), and the leaf's name."""
    return max((float((got[n].detach().float().cpu() - w.float().cpu())
                      .abs().max() / w.float().abs().max().clamp(
                          min=1e-30)), n) for n, w in want.items())


def state_err(torch, got, want) -> tuple:
    """:func:`leaf_err` over every tree of two optimizer states (named
    tuples of a step count and name -> tensor maps); the step counts must
    be equal."""
    check(int(got.step) == int(want.step),
          f"optimizer step counts {int(got.step)} and {int(want.step)}")
    return max(leaf_err(torch, getattr(got, f), getattr(want, f)) + (f,)
               for f in want._fields if f != "step")


def to_cpu(torch, tree):
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.detach().cpu().clone(), tree)


def optimizer_cost(torch, fn) -> tuple:
    """``(device ms, host ms, kernel launches, DtoH copies, HtoD copies)``
    of one call of ``fn``: the kernels' time as :func:`device_ms` sums it,
    the host clock around synchronized calls (an optimizer step is host
    bound: its device time is a share of it), the counts of
    :func:`step_counts`."""
    kernels, dtoh, htod = step_totals(step_counts(torch, fn))
    return (device_ms(torch, fn, iters=3), 1e3 * _host_time(torch, fn, 3),
            kernels, dtoh, htod)


def train_lamb(torch, kern, card: str) -> dict:
    """BERT-base pretraining (``train_bert``'s model and batch: 16 x 512,
    bf16 compute over fp32 params, ``DynamicLossScale(2**12)``) with the
    LAMB ``TrainConfig`` builds for ``OptimizerConfig(name="lamb",
    **LAMB)``, :data:`LAMB_STEPS` steps, each launching each flash kernel
    12 times and each LayerNorm kernel 26 times. Each step's new params
    and LAMB state against the port's LAMB stepped on the CPU from the
    same grads, params and state (:data:`TOL_LAMB_STEP`); every loss
    finite; beside it a ``FusedMixedPrecisionLamb`` leg over bf16 copies
    of the params fed the scaled grads with ``grad_scale`` the live loss
    scale, its masters against ``FusedLAMB`` on fp32 copies fed the
    unscaled grads (:data:`TOL_MP_LAMB`) and its bf16 params equal to the
    masters rounded. Then the LAMB step's device ms, launches and copies
    (no device-to-host copy) beside ``FusedAdam``'s (``train_bert``'s
    optimizer) on the same grads. Returns the steps' launch counts."""
    from apex_tpu_torch.amp import DynamicLossScale, all_finite
    from apex_tpu_torch.config import OptimizerConfig, TrainConfig
    from apex_tpu_torch.models import BertModel
    from apex_tpu_torch.optimizers import (FusedAdam, FusedLAMB,
                                           FusedMixedPrecisionLamb)

    cfg = bert_base(torch)
    batch = bert_batch(torch, cfg)
    real = int(batch["attention_mask"].sum())
    opt = TrainConfig(optimizer=OptimizerConfig(
        name="lamb", **LAMB)).build_optimizer()
    check(type(opt) is FusedLAMB and (
        opt.lr, (opt.beta1, opt.beta2), opt.eps, opt.weight_decay,
        opt.max_grad_norm, opt.adam_w_mode) == (
        LAMB["lr"], LAMB["betas"], LAMB["eps"], LAMB["weight_decay"], 1.0,
        True), f"train_lamb: TrainConfig built {opt!r}, {vars(opt)}")
    torch.cuda.empty_cache()
    model = BertModel(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    state = opt.init(params)
    scaler = DynamicLossScale(init_scale=2.0 ** 12)
    ls = scaler.init(device="cuda")
    cpu_opt = FusedLAMB(**LAMB)
    # the mixed-precision leg: bf16 model params, and FusedLAMB over fp32
    # copies of their values
    mp, ref = FusedMixedPrecisionLamb(**LAMB), FusedLAMB(**LAMB)
    mp_params = {n: p.detach().to(torch.bfloat16) for n, p in params.items()}
    mp_state = mp.init(mp_params)
    ref_params = {n: p.float() for n, p in mp_params.items()}
    ref_state = ref.init(ref_params)
    want = bert_launches(cfg.num_layers)
    launches = {name: 0 for name in kern.LAUNCHES}
    losses, times, step_errs, mp_errs = [], [], [], []
    for i in range(LAMB_STEPS):
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        for p in params.values():
            p.grad = None
        loss = model.loss(**batch)
        (loss * ls.loss_scale).backward()
        loss = loss.detach()
        scaled = {n: p.grad for n, p in params.items()}
        grads = scaler.unscale(ls, scaled)
        finite = all_finite(grads)
        torch.cuda.synchronize()
        fwd_bwd = time.perf_counter() - t0
        counts = dict(kern.LAUNCHES)
        check(counts == want, f"train_lamb step {i}: launches {counts}, "
                              f"want {want}")
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"train_lamb step {i}: loss {float(loss)} or grads not finite")
        for name, n in counts.items():
            launches[name] += n
        before = to_cpu(torch, (params, state, grads, finite))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        opt.step(grads, state, params, grads_finite=finite)
        torch.cuda.synchronize()
        times.append(fwd_bwd + time.perf_counter() - t0)
        losses.append(float(loss))
        p_cpu, s_cpu, g_cpu, f_cpu = before
        cpu_opt.step(g_cpu, s_cpu, p_cpu, grads_finite=f_cpu)
        step_errs.append(max(leaf_err(torch, params, p_cpu) + ("params",),
                             state_err(torch, state, s_cpu)))
        mp.step(scaled, mp_state, mp_params, grads_finite=finite,
                grad_scale=ls.loss_scale)
        ref.step(grads, ref_state, ref_params, grads_finite=finite)
        mp_errs.append(max(leaf_err(torch, mp_state.master_params,
                                    ref_params) + ("masters",),
                           state_err(torch, mp_state, ref_state)))
        check(all(torch.equal(mp_params[n], m.to(torch.bfloat16))
                  for n, m in mp_state.master_params.items()),
              f"train_lamb step {i}: the bf16 params are not the masters "
              "rounded")
        ls = scaler.update(ls, finite)
        del before, p_cpu, s_cpu, g_cpu, scaled
        print(f"train_lamb step {i}: loss {losses[-1]:.6f}, "
              f"{1e3 * times[-1]:.3f} ms (host clock, synchronized), the "
              f"card's LAMB step against the CPU's: worst "
              f"{step_errs[-1][1]} {step_errs[-1][2]} {step_errs[-1][0]:.3g}"
              f" of its max (tol {TOL_LAMB_STEP}); mixed-precision masters "
              f"against FusedLAMB: worst {mp_errs[-1][1]} "
              f"{mp_errs[-1][2]} {mp_errs[-1][0]:.3g} (tol {TOL_MP_LAMB}) "
              f"[{card}]")
        check(step_errs[-1][0] <= TOL_LAMB_STEP,
              f"train_lamb step {i}: the card's LAMB step vs the CPU's "
              f"{step_errs[-1]}")
        check(mp_errs[-1][0] <= TOL_MP_LAMB,
              f"train_lamb step {i}: mixed-precision LAMB vs FusedLAMB "
              f"{mp_errs[-1]}")
    del mp_params, mp_state, ref_params, ref_state
    torch.cuda.empty_cache()

    lamb_cost = optimizer_cost(torch, lambda: opt.step(
        grads, state, params, grads_finite=finite))
    adam = FusedAdam(lr=1e-4)
    adam_params = {n: p.detach().clone() for n, p in params.items()}
    adam_state = adam.init(adam_params)
    adam_cost = optimizer_cost(torch, lambda: adam.step(
        grads, adam_state, adam_params, grads_finite=finite))
    for name, cost in (("FusedLAMB", lamb_cost), ("FusedAdam", adam_cost)):
        check(cost[3] == 0, f"train_lamb: a {name} step makes {cost[3]} "
                            "device-to-host copies")
    steady = sorted(times[1:])[len(times[1:]) // 2]
    tokens_n = BERT_BH[0] * BERT_ATTN[1]
    print(f"train_lamb: BERT-base with LAMB (lr {LAMB['lr']}, betas "
          f"{LAMB['betas']}, eps {LAMB['eps']}, weight decay "
          f"{LAMB['weight_decay']}, max grad norm 1.0; batch {BERT_BH[0]} x "
          f"{BERT_ATTN[1]}, {real} real tokens, bf16 compute, fp32 params), "
          f"losses {[f'{x:.6f}' for x in losses]}, median step "
          f"{1e3 * steady:.3f} ms after the first ({1e3 * times[0]:.3f} ms), "
          f"{tokens_n / steady:.1f} tokens/s ({real / steady:.1f} real); "
          f"the optimizer step alone, (device ms, host ms, launches, DtoH, "
          f"HtoD): FusedLAMB ({lamb_cost[0]:.3f}, {lamb_cost[1]:.3f}, "
          f"{lamb_cost[2]}, {lamb_cost[3]}, {lamb_cost[4]}), FusedAdam on the "
          f"same grads ({adam_cost[0]:.3f}, {adam_cost[1]:.3f}, "
          f"{adam_cost[2]}, {adam_cost[3]}, {adam_cost[4]}); launches "
          f"{launches} [{card}]")
    del model, params, state, grads, adam_params, adam_state, opt
    torch.cuda.empty_cache()
    return launches


# the optimizer legs on GPT-small's grads (train's batch, 8 x 1024)
GPT_SMALL = dict(vocab_size=32768, hidden_size=768, num_layers=12,
                 num_attention_heads=12, max_position_embeddings=1024)
OPTIM_LEG_STEPS = 3
# each leg on the card against the same optimizer on the CPU from the same
# params and grads, of each leaf's max |CPU|: elementwise arithmetic alike,
# the per-tensor norms summed in other orders
TOL_OPTIM_LEG = 1e-5
# bench_headline's step under LARC(FusedSGD(momentum=0.9)) at the
# reference's defaults (trust 0.02, clip), step 0's update card vs CPU
LARC_RESNET_STEPS = 3


def optim_legs(torch, kern, card: str) -> dict:
    """One forward and backward of GPT-small at ``train``'s batch gives
    the grads (each flash kernel 12 launches, each LayerNorm kernel 25);
    on them each leg runs :data:`OPTIM_LEG_STEPS` steps (the grads times
    1, 2, 3) on the card and the same on the CPU (:data:`TOL_OPTIM_LEG`):
    ``FusedNovoGrad`` at ``norm_type`` 2 and 0 in both moment modes,
    ``FusedAdagrad`` in both modes, ``LARC(FusedSGD)`` and
    ``LARC(FusedAdam)``; ``FlatOptimizer(FusedAdagrad)`` must equal the
    per-leaf run bit for bit. The ``multi_tensor_*`` functions on the
    grads (the flags, with one injected ``inf``; the global norm against
    ``torch.linalg.vector_norm``) and the native ``flatten``/``unflatten``
    /``gather_rows`` round-tripped, with ``native_available()`` true. Then
    ``bench_headline``'s ResNet-50 step (256 x 224 x 224 bf16) for
    :data:`LARC_RESNET_STEPS` steps under ``LARC(FusedSGD(lr=0.1,
    momentum=0.9, weight_decay=1e-4))``, step 0's update against the CPU.
    Returns the launch counts of the GPT pass."""
    import numpy as np
    import torch.nn.functional as F
    from apex_tpu_torch import _native
    from apex_tpu_torch.amp import DynamicLossScale, all_finite
    from apex_tpu_torch.models import (GPTConfig, GPTModel, ResNet50,
                                       ResNetConfig)
    from apex_tpu_torch.multi_tensor_apply import (multi_tensor_axpby,
                                                   multi_tensor_l2norm,
                                                   multi_tensor_scale)
    from apex_tpu_torch.optimizers import (LARC, FlatOptimizer,
                                           FusedAdagrad, FusedAdam,
                                           FusedNovoGrad, FusedSGD)

    cfg = GPTConfig(**GPT_SMALL)
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, TRAIN_BH[:1] + TRAIN_ATTN[1:2])).to("cuda")
    model = GPTModel(cfg, device="cuda").init(
        torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    kern.reset_launches()
    model.loss(tokens, tokens).backward()
    torch.cuda.synchronize()
    launches = dict(kern.LAUNCHES)
    L = cfg.num_layers
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == L, f"optim_legs: {name} launched "
                                   f"{launches[name]} times, not {L}")
    for name in ("ln_fwd", "ln_bwd"):
        check(launches[name] == LN_PER_GPT_PASS,
              f"optim_legs: {name} launched {launches[name]} times")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads = {n: p.grad.detach() for n, p in model.named_parameters()}
    del model
    torch.cuda.empty_cache()
    check(bool(all_finite(grads)), "optim_legs: GPT grads not finite")
    p_cpu, g_cpu = to_cpu(torch, (params, grads))
    legs = {
        "novograd l2": lambda: FusedNovoGrad(lr=1e-2, weight_decay=1e-3),
        "novograd l2 reg_inside_moment": lambda: FusedNovoGrad(
            lr=1e-2, weight_decay=1e-3, reg_inside_moment=True),
        "novograd linf": lambda: FusedNovoGrad(lr=1e-2, weight_decay=1e-3,
                                               norm_type=0),
        "novograd linf reg_inside_moment": lambda: FusedNovoGrad(
            lr=1e-2, weight_decay=1e-3, norm_type=0, reg_inside_moment=True),
        "adagrad": lambda: FusedAdagrad(lr=1e-2, weight_decay=1e-3),
        "adagrad_w_mode": lambda: FusedAdagrad(lr=1e-2, weight_decay=1e-3,
                                               adagrad_w_mode=True),
        "LARC(FusedSGD)": lambda: LARC(FusedSGD(lr=0.1, momentum=0.9,
                                                weight_decay=1e-4)),
        "LARC(FusedAdam)": lambda: LARC(FusedAdam(lr=1e-3,
                                                  weight_decay=1e-2)),
    }
    results = {}
    for name, make in legs.items():
        runs = []
        for dev_params, dev_grads in ((params, grads), (p_cpu, g_cpu)):
            opt = make()
            p = {n: t.clone() for n, t in dev_params.items()}
            st = opt.init(p)
            for i in range(OPTIM_LEG_STEPS):
                opt.step({n: g * float(i + 1) for n, g in dev_grads.items()},
                         st, p)
            runs.append((p, st))
        (p_card, s_card), (p_host, s_host) = runs
        results[name] = max(leaf_err(torch, p_card, p_host) + ("params",),
                            state_err(torch, s_card, s_host))
        check(results[name][0] <= TOL_OPTIM_LEG,
              f"optim_legs {name}: card vs CPU {results[name]}")
        if name.startswith("adagrad"):
            flat = FlatOptimizer(make())
            fp = {n: t.clone() for n, t in params.items()}
            fst = flat.init(fp)
            for i in range(OPTIM_LEG_STEPS):
                flat.step({n: g * float(i + 1) for n, g in grads.items()},
                          fst, fp)
            check(all(torch.equal(fp[n], p_card[n]) for n in fp),
                  f"optim_legs: FlatOptimizer({name}) differs from the "
                  "per-leaf run")
            results[f"FlatOptimizer({name}) vs per-leaf"] = (
                0.0, "every leaf", "bit for bit")
            del flat, fp, fst
        del runs, p_card, s_card, p_host, s_host
        torch.cuda.empty_cache()
    print(f"optim_legs: GPT-small grads (8 x 1024, bf16 compute), "
          f"{OPTIM_LEG_STEPS} steps each, card vs CPU, worst leaf's max "
          f"|diff| / max |CPU| (tol {TOL_OPTIM_LEG}): " + "; ".join(
              f"{name} {err:.3g} ({leaf}, {what})"
              for name, (err, leaf, what) in results.items())
          + f" [{card}]")

    # the multi_tensor functions on the grads
    first = next(iter(grads))
    poisoned = dict(grads)
    poisoned[first] = grads[first].clone()
    poisoned[first].view(-1)[0] = float("inf")
    half, ok = multi_tensor_scale(grads, 0.5)
    _, bad = multi_tensor_scale(poisoned, 0.5)
    same, ok2 = multi_tensor_axpby(2.0, grads, -1.0, grads)
    _, bad2 = multi_tensor_axpby(2.0, poisoned, -1.0, grads)
    check(bool(ok) and bool(ok2) and not bool(bad) and not bool(bad2),
          f"optim_legs: finite flags {bool(ok)}, {bool(ok2)}, with an inf "
          f"{bool(bad)}, {bool(bad2)}")
    check(all(torch.equal(half[n], g * 0.5) and torch.equal(same[n], g)
              for n, g in grads.items()),
          "optim_legs: multi_tensor_scale or axpby values differ")
    gnorm, per = multi_tensor_l2norm(grads, per_tensor=True)
    want = torch.linalg.vector_norm(torch.cat([g.reshape(-1)
                                               for g in grads.values()]))
    norm_err = abs(float(gnorm) / float(want) - 1)
    per_err = max(abs(float(per[n]) / float(torch.linalg.vector_norm(g))
                      - 1) for n, g in grads.items())
    check(max(norm_err, per_err) <= TOL_GRAD_NORM,
          f"optim_legs: multi_tensor_l2norm {float(gnorm)} vs vector_norm "
          f"{float(want)}: {norm_err:.3g}, per tensor {per_err:.3g}")

    # the native host packing
    check(_native.native_available(), "optim_legs: the native library did "
                                      "not build (g++)")
    arrays = [g_cpu[n].numpy() for n in list(g_cpu)[:8]]
    packed = _native.flatten(arrays)
    back = _native.unflatten(packed, arrays)
    table = g_cpu["embedding.word.weight"].numpy()
    idx = np.random.RandomState(1).randint(0, table.shape[0], 4096)
    rows = _native.gather_rows(table, idx)
    check(packed.nbytes == sum(a.nbytes for a in arrays)
          and all(np.array_equal(a, b) for a, b in zip(arrays, back))
          and np.array_equal(rows, table[idx]),
          "optim_legs: native flatten/unflatten/gather_rows round trip")
    print(f"optim_legs: multi_tensor_scale/axpby flags True, with one inf "
          f"False; multi_tensor_l2norm {float(gnorm):.6f} against "
          f"vector_norm {float(want):.6f} ({norm_err:.3g}, per tensor worst "
          f"{per_err:.3g}; tol {TOL_GRAD_NORM}); native_available True, "
          f"flatten/unflatten of {len(arrays)} arrays ({packed.nbytes} "
          f"bytes) and gather_rows of {idx.size} rows round-tripped "
          f"[{card}]")
    del params, grads, p_cpu, g_cpu, poisoned, half, same, per
    torch.cuda.empty_cache()

    # bench_headline's ResNet-50 step under LARC(FusedSGD)
    rcfg = ResNetConfig(num_classes=1000, compute_dtype=torch.bfloat16)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(HEADLINE_BATCH, HEADLINE_IMG,
                                   HEADLINE_IMG, 3).astype(np.float32)).to(
        "cuda", torch.bfloat16)
    labels = torch.from_numpy(rng.randint(0, 1000, HEADLINE_BATCH)).to(
        "cuda")
    net = ResNet50(rcfg, device="cuda").init(torch.Generator().manual_seed(0))
    rparams = dict(net.named_parameters())

    def make_larc():
        return LARC(FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4))

    opt = make_larc()
    ost = opt.init(rparams)
    scaler = DynamicLossScale(init_scale=2.0 ** 12)
    ls = scaler.init(device="cuda")
    kern.reset_launches()
    losses, times = [], []
    for i in range(LARC_RESNET_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in rparams.values():
            p.grad = None
        loss = F.cross_entropy(net(x), labels)
        (loss * ls.loss_scale).backward()
        loss = loss.detach()
        g = scaler.unscale(ls, {n: p.grad for n, p in rparams.items()})
        finite = all_finite(g)
        copy_s = 0.0
        if i == 0:       # the state before step 0, for the CPU (untimed)
            torch.cuda.synchronize()
            c0 = time.perf_counter()
            host = to_cpu(torch, (rparams, ost, g, finite))
            copy_s = time.perf_counter() - c0
        ls = scaler.update(ls, finite)
        opt.step(g, ost, rparams, grads_finite=finite)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0 - copy_s)
        losses.append(float(loss))
        check(bool(finite) and np.isfinite(losses[-1]),
              f"optim_legs ResNet-50 LARC step {i}: loss {losses[-1]} or "
              "grads not finite")
        if i == 0:
            hp, hs, hg, hf = host
            make_larc().step(hg, hs, hp, grads_finite=hf)
            larc_err = max(leaf_err(torch, rparams, hp) + ("params",),
                           state_err(torch, ost, hs))
            check(larc_err[0] <= TOL_OPTIM_LEG,
                  f"optim_legs ResNet-50 LARC step 0 card vs CPU {larc_err}")
            del host, hp, hs, hg
    check(sum(kern.LAUNCHES.values()) == 0,
          "optim_legs: the ResNet-50 LARC steps launched the port's kernels")
    print(f"optim_legs: ResNet-50 (bench_headline, {HEADLINE_BATCH} x "
          f"{HEADLINE_IMG}^2 bf16) under LARC(FusedSGD(lr 0.1, momentum 0.9,"
          f" weight decay 1e-4), trust 0.02, clip): losses "
          f"{[f'{v:.4f}' for v in losses]}, steps "
          f"{[f'{1e3 * t:.3f}' for t in times]} ms (host clock, "
          f"synchronized), step 0's update card vs CPU worst {larc_err[1]} "
          f"{larc_err[2]} {larc_err[0]:.3g} (tol {TOL_OPTIM_LEG}) [{card}]")
    del net, rparams, opt, ost, x, labels, g
    torch.cuda.empty_cache()
    return launches


# fairseq's transformer_vaswani_wmt_en_de_big: embed 1024, 16 heads (d 64),
# FFN 4096, a shared 32768 vocab, pad index 1; 28 sentences of 128 source
# and 96 target tokens (3584 source tokens, --max-tokens 3584 of its
# scaling-NMT recipe); attention dropout 0.1 from a seed, bf16 compute
BIG = dict(embed=1024, heads=16, ffn=4096, vocab=32768, pad=1, batch=28,
           src=128, tgt=96)
BIG_DROPOUT = 0.1
BIG_SEEDS = (11, 12, 13)          # the three attention modules' dropout
# a block of each kernel's three flash launches, each LayerNorm kernel's
# seven (the four pre-norms, the two FFN norms' ... see big_forward)
BIG_LAUNCHES = {"flash_fwd": 3, "flash_bwd_dq": 3, "flash_bwd_dkv": 3,
                "ln_fwd": 7, "ln_bwd": 7}
# the kernel path against use_kernel=False on the card, bf16: the block
# outputs and every grad as relative norms, the loss absolute. The outputs
# and the loss take BERT's limits (the same kernels at the same d); the
# grads 5e-2: the pre-norms' bias grads are sums over 2688-3584 rows
# whose terms cancel, so the one-ulp bf16 differences of the two
# forwards (B1 rounds P before P V where the plain version rounds the
# normalized P) come out larger relative to them (0.0276 at the decoder
# cross-attention's norm bias, PERF.md §6). Both
# paths' distance to an fp32 run of the plain path is printed beside it.
TOL_BIG_OUT = 2e-2
TOL_BIG_LOSS = 1e-2
TOL_BIG_GRAD = 5e-2
# FusedScaleMaskSoftmax at GPT-small's causal scores and BERT's padded
# ones (b, heads, sq, sk), bf16 out against an fp32 softmax of the same
# masked scores on the card: within one bf16 ulp of the fp32 value (its
# rounding moves it by at most half of one), exact where the fp32 value
# is 0 (a dropped score)
SOFTMAX_SHAPES = {"GPT-small causal": (8, 12, 1024, 1024),
                  "BERT padding": (16, 12, 512, 512)}


def bf16_ulps(torch, got, ref) -> float:
    """The largest ``|got - ref|`` in units of the bf16 ulp at ``ref``
    (``inf`` where ``ref`` is 0 and ``got`` is not)."""
    _, exp = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), exp - 8)   # |ref| in [2^(e-1), 2^e)
    diff = (got.float() - ref).abs()
    ratio = torch.where(ref == 0, torch.where(diff == 0, 0.0, float("inf")),
                        diff / ulp)
    return float(ratio.max())
# apex's MLP test sizes, batch 1024, fp32, card against CPU (GEMMs sum in
# other orders): relative norm of outputs and grads. With ReLU, a
# pre-activation within rounding of 0 may take the other side on the
# other device and move that sample's share of a layer's grad (1.1e-3 of
# the norm, PERF.md §6): the ReLU MLP is held on
# its output, and forward and backward are held with the sigmoid, which
# has no kink
MLP_SIZES = (480, 1024, 1024, 512, 256, 1)
MLP_BATCH = 1024
TOL_MLP = 1e-5


def big_model(torch, use_kernel, state=None):
    """The Transformer-big encoder and decoder block (:data:`BIG`) as an
    ``nn.ModuleDict`` on the card, drawn from a seed or loaded from
    ``state``."""
    from torch import nn
    from apex_tpu_torch.normalization import FusedLayerNorm
    from apex_tpu_torch.ops import (EncdecMultiheadAttn,
                                    FusedDenseGeluDense, SelfMultiheadAttn)
    e, h, f = BIG["embed"], BIG["heads"], BIG["ffn"]
    attn = dict(dropout=BIG_DROPOUT, include_norm_add=True, device="cuda",
                use_kernel=use_kernel)
    norm = dict(device="cuda", use_kernel=use_kernel)
    m = nn.ModuleDict({
        "embed": nn.ParameterDict({"weight": nn.Parameter(torch.empty(
            BIG["vocab"], e, device="cuda"))}),
        "enc_attn": SelfMultiheadAttn(e, h, **attn),
        "enc_ln": FusedLayerNorm(e, **norm),
        "enc_ffn": FusedDenseGeluDense(e, f, e, device="cuda"),
        "enc_final": FusedLayerNorm(e, **norm),
        "dec_self": SelfMultiheadAttn(e, h, **attn),
        "dec_cross": EncdecMultiheadAttn(e, h, **attn),
        "dec_ln": FusedLayerNorm(e, **norm),
        "dec_ffn": FusedDenseGeluDense(e, f, e, device="cuda"),
        "dec_final": FusedLayerNorm(e, **norm)})
    if state is not None:
        m.load_state_dict(state)
        return m
    gen = torch.Generator().manual_seed(0)
    for name in ("enc_attn", "enc_ffn", "dec_self", "dec_cross", "dec_ffn"):
        m[name].init(gen)
    with torch.no_grad():
        m["embed"]["weight"].copy_(torch.randn(
            BIG["vocab"], e, generator=gen) * e ** -0.5)
    return m


def big_batch(torch):
    """28 source sentences of 128 tokens and target sentences of 96 (the
    teacher-forced input and the shifted output), lengths drawn from
    ``RandomState(0)``, padded with index 1."""
    import numpy as np
    rng = np.random.RandomState(0)
    b, s, t, pad = BIG["batch"], BIG["src"], BIG["tgt"], BIG["pad"]
    src = rng.randint(2, BIG["vocab"], (b, s))
    tgt = rng.randint(2, BIG["vocab"], (b, t + 1))
    src_len = rng.randint(s // 2, s + 1, b)
    tgt_len = rng.randint(t // 2, t + 1, b)
    src_len[0], tgt_len[0] = s, t
    src[np.arange(s)[None, :] >= src_len[:, None]] = pad
    tgt[np.arange(t + 1)[None, :] >= tgt_len[:, None]] = pad
    out = dict(src=src, tgt_in=tgt[:, :-1], tgt_out=tgt[:, 1:])
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
            for k, v in out.items()}


def big_forward(torch, m, batch, dtype=None):
    """The block's forward: the encoder (``SelfMultiheadAttn`` with
    norm-add and the source padding mask, then ``x + FFN(LN(x))``, a final
    LN), the decoder (a causal ``SelfMultiheadAttn`` with norm-add and the
    target padding mask, ``EncdecMultiheadAttn`` with norm-add over the
    encoder output and the source mask, ``y + FFN(LN(y))``, a final LN),
    the tied output projection and ``SoftmaxCrossEntropyLoss.apply(...,
    smoothing=0.1, padding_idx=1, half_to_float=True)`` summed over the
    target tokens that are not padding, computed in ``dtype`` (default
    bf16). Returns ``(encoder out, decoder out, loss)``."""
    from apex_tpu_torch.ops import SoftmaxCrossEntropyLoss
    dt, pad = dtype or torch.bfloat16, BIG["pad"]
    emb = m["embed"]["weight"]
    src_mask = batch["src"] == pad
    x = emb[batch["src"]].to(dt).transpose(0, 1)              # (S, B, E)
    x = m["enc_attn"](x, key_padding_mask=src_mask,
                      dropout_seed=BIG_SEEDS[0])
    x = x + m["enc_ffn"](m["enc_ln"](x))
    enc = m["enc_final"](x)
    y = emb[batch["tgt_in"]].to(dt).transpose(0, 1)           # (T, B, E)
    y = m["dec_self"](y, key_padding_mask=batch["tgt_in"] == pad,
                      attn_mask_causal=True, dropout_seed=BIG_SEEDS[1])
    y = m["dec_cross"](y, enc, key_padding_mask=src_mask,
                       dropout_seed=BIG_SEEDS[2])
    y = y + m["dec_ffn"](m["dec_ln"](y))
    dec = m["dec_final"](y)
    logits = dec.transpose(0, 1).reshape(-1, BIG["embed"]) @ emb.to(dt).t()
    labels = batch["tgt_out"].reshape(-1)
    losses = SoftmaxCrossEntropyLoss.apply(logits, labels, 0.1, pad, True)
    return enc, dec, losses.sum() / (labels != pad).sum()


def big_kernel_timings(torch, fa, kern, card: str) -> None:
    """B1-B3 at the block's three attention shapes (448 batch-heads, d 64,
    bf16, the padding bias): encoder self 128 x 128, decoder causal self
    96 x 96, cross 96 x 128; kernel and plain device ms and SDPA's with
    the same float mask, beside the bound over the visible pairs."""
    gen = torch.Generator(device="cuda").manual_seed(21)
    b, h, d = BIG["batch"], BIG["heads"], BIG["embed"] // BIG["heads"]
    n = b * h
    lengths = torch.randint(BIG["src"] // 2, BIG["src"] + 1, (b,),
                            generator=gen, device="cuda")
    for what, sq, sk, causal in (("encoder self", BIG["src"], BIG["src"],
                                  False),
                                 ("decoder causal self", BIG["tgt"],
                                  BIG["tgt"], True),
                                 ("cross", BIG["tgt"], BIG["src"], False)):
        q, do = (torch.randn((n, sq, d), generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((n, sk, d), generator=gen, device="cuda").to(
            torch.bfloat16) for _ in range(2))
        bias = torch.where(torch.arange(sk, device="cuda")[None, :]
                           < lengths[:, None] * sk // BIG["src"], 0.0,
                           -10000.0)[:, None, None, :]
        scale = d ** -0.5
        out, lse = kern.flash_fwd(q, k, v, causal, scale, bias=bias)
        delta = (do.float() * out.float()).sum(dim=-1)
        args = (q, k, v, do, lse, delta, causal, scale)
        kernel = {"flash_fwd": lambda: kern.flash_fwd(q, k, v, causal, scale,
                                                      bias=bias),
                  "flash_bwd_dq": lambda: kern.flash_bwd_dq(*args, bias=bias),
                  "flash_bwd_dkv": lambda: kern.flash_bwd_dkv(*args,
                                                              bias=bias)}
        plain_fn = {"flash_fwd": lambda: fa._flash_fwd_plain(
            q, k, v, causal, scale, bias=bias),
            "flash_bwd_dq": lambda: fa._flash_bwd_dq_plain(*args, bias=bias),
            "flash_bwd_dkv": lambda: fa._flash_bwd_dkv_plain(*args,
                                                             bias=bias)}
        ms = {name: device_ms(torch, fn) for name, fn in kernel.items()}
        plain = {name: device_ms(torch, fn, iters=5)
                 for name, fn in plain_fn.items()}
        q4, k4, v4, do4 = (t.view(b, h, -1, d) for t in (q, k, v, do))
        mask = bias.to(torch.bfloat16)
        if causal:
            mask = mask + torch.where(torch.ones(sq, sk, dtype=torch.bool,
                                                 device="cuda").tril(),
                                      0.0, -10000.0).to(torch.bfloat16)
        lib_fwd = device_ms(torch, lambda: torch.nn.functional
                            .scaled_dot_product_attention(q4, k4, v4,
                                                          attn_mask=mask))
        qg, kg, vg = (t.detach().requires_grad_() for t in (q4, k4, v4))
        sdpa = torch.nn.functional.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask)
        lib_bwd = device_ms(torch, lambda: torch.autograd.grad(
            sdpa, (qg, kg, vg), do4, retain_graph=True))
        pairs = n * (sq * (sq + 1) // 2 if causal else sq * sk)
        rows = n * sq * 4
        work = {"flash_fwd": (2 * nbytes_of(q) + 2 * nbytes_of(k) + rows
                              + nbytes_of(bias), 2 * 2 * pairs * d),
                "flash_bwd_dq": (3 * nbytes_of(q) + 2 * nbytes_of(k)
                                 + 2 * rows + nbytes_of(bias),
                                 3 * 2 * pairs * d),
                "flash_bwd_dkv": (2 * nbytes_of(q) + 4 * nbytes_of(k)
                                  + 2 * rows + nbytes_of(bias),
                                  4 * 2 * pairs * d)}
        for name in kernel:
            b_ms, b_by = bound(*work[name])
            print(f"transformer_ops {name} at the {what} shape ({n} x {sq} x"
                  f" {sk}, d {d}, bf16, padding bias"
                  f"{', causal' if causal else ''}): kernel {ms[name]:.4f} "
                  f"ms, plain {plain[name]:.4f} ms, SDPA with a float mask "
                  f"{'fwd' if name == 'flash_fwd' else 'bwd (dq+dk+dv)'} "
                  f"{lib_fwd if name == 'flash_fwd' else lib_bwd:.4f} ms, "
                  f"bound {b_ms:.5f} ms ({b_by}) [{card}]")
        del q, k, v, do, qg, kg, vg, sdpa


def transformer_ops(torch, fa, kern, card: str) -> dict:
    """A Transformer-big encoder and decoder block (:data:`BIG`,
    ``big_forward``) forward and backward on the kernel path, which must
    launch :data:`BIG_LAUNCHES`, against ``use_kernel=False`` on the card
    from one state dict (the same dropout seeds): the block outputs, the
    loss and every grad (``TOL_BIG_*``); the step's host-clock time and a
    profile by kernel; B1-B3 at the block's shapes
    (``big_kernel_timings``). Then ``FusedScaleMaskSoftmax``, causal at
    GPT-small's scores (8 x 12 x 1024 x 1024 bf16, scale 1/8) and with a
    padding mask at BERT's (16 x 12 x 512 x 512, one query row fully
    masked), each within one bf16 ulp of an fp32 softmax and the
    masked row uniform; and ``MLP(MLP_SIZES)`` at batch 1024, forward and
    backward in fp32, card against CPU (:data:`TOL_MLP`). Returns the
    kernel path's launch counts."""
    import numpy as np
    from apex_tpu_torch.ops import AttnMaskType, FusedScaleMaskSoftmax, MLP

    batch = big_batch(torch)
    init = big_model(torch, None)
    state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    runs = {}
    for use_kernel, dtype in ((True, torch.bfloat16), (False, torch.bfloat16),
                              (False, torch.float32)):
        m = big_model(torch, use_kernel, state)
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        enc, dec, loss = big_forward(torch, m, batch, dtype)
        loss.backward()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        counts = dict(kern.LAUNCHES)
        loss = loss.detach()
        check(bool(torch.isfinite(loss)), f"transformer_ops: loss {loss}")
        runs[use_kernel, dtype] = (enc.detach(), dec.detach(), float(loss),
                                   {n: p.grad.detach() for n, p in
                                    m.named_parameters()}, counts, elapsed)
        if use_kernel:
            def step():
                for p in m.parameters():
                    p.grad = None
                big_forward(torch, m, batch)[2].backward()

            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                step()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            profile_step(torch, "transformer_ops block forward + backward "
                                "(28 x 128 / 96 tokens, bf16)", step, card,
                         iters=2, top=12)
        del m
        torch.cuda.empty_cache()
    enc_k, dec_k, loss_k, grads_k, launches, _ = runs[True, torch.bfloat16]
    enc_p, dec_p, loss_p, grads_p, plain_counts, plain_s = runs[
        False, torch.bfloat16]
    grads_32 = runs[False, torch.float32][3]
    want = {name: BIG_LAUNCHES.get(name, 0) for name in kern.LAUNCHES}
    check(launches == want, f"transformer_ops: launches {launches}, want "
                            f"{want}")
    check(sum(plain_counts.values()) == 0,
          f"transformer_ops: the plain path launched {plain_counts}")
    out_err = max(float((a.float() - b.float()).norm() / b.float().norm())
                  for a, b in ((enc_k, enc_p), (dec_k, dec_p)))
    loss_err = abs(loss_k - loss_p)
    g_err, g_leaf = grad_rel(torch, grads_k, grads_p)
    worst3 = sorted(((float((grads_k[n] - w).norm() / w.norm().clamp(
        min=1e-30)), n) for n, w in grads_p.items()), reverse=True)[:3]
    to_fp32 = [grad_rel(torch, g, grads_32) for g in (grads_k, grads_p)]
    print(f"transformer_ops: Transformer-big block (embed {BIG['embed']}, "
          f"{BIG['heads']} heads, FFN {BIG['ffn']}, vocab {BIG['vocab']}; "
          f"{BIG['batch']} x {BIG['src']} source / {BIG['tgt']} target "
          f"tokens, bf16, attention dropout {BIG_DROPOUT}), kernel path vs "
          f"use_kernel=False: block outputs {out_err:.4g} (relative norm, "
          f"tol {TOL_BIG_OUT}), loss {loss_k:.6f} vs {loss_p:.6f} "
          f"({loss_err:.3g}, tol {TOL_BIG_LOSS}), grads worst leaves "
          f"{[(n, round(e, 5)) for e, n in worst3]} (tol {TOL_BIG_GRAD}); "
          f"each path's grads against an fp32 plain run, worst leaf: kernel "
          f"{to_fp32[0][1]} {to_fp32[0][0]:.4g}, plain {to_fp32[1][1]} "
          f"{to_fp32[1][0]:.4g}; forward + backward "
          f"{[f'{1e3 * t:.3f}' for t in times]} ms (host clock, "
          f"synchronized), the plain path {1e3 * plain_s:.3f} ms; "
          f"launches {launches} [{card}]")
    check(out_err <= TOL_BIG_OUT, f"transformer_ops block outputs {out_err}")
    check(loss_err <= TOL_BIG_LOSS, f"transformer_ops loss {loss_err}")
    check(g_err <= TOL_BIG_GRAD, f"transformer_ops grads {g_leaf} {g_err}")
    del runs, grads_k, grads_p, grads_32
    torch.cuda.empty_cache()
    big_kernel_timings(torch, fa, kern, card)

    # FusedScaleMaskSoftmax at GPT-small's and BERT's scores
    gen = torch.Generator(device="cuda").manual_seed(22)
    worst = {}
    for what, shape in SOFTMAX_SHAPES.items():
        kind = (AttnMaskType.causal if "causal" in what
                else AttnMaskType.padding)
        scale = 0.125
        x = (torch.randn(shape, generator=gen, device="cuda") * 4).to(
            torch.bfloat16)
        sq, sk = shape[-2:]
        if kind == AttnMaskType.causal:
            mask = torch.ones(sq, sk, dtype=torch.bool,
                              device="cuda").triu(1)[None, None]
        else:
            lengths = torch.randint(sk // 2, sk + 1, (shape[0],),
                                    generator=gen, device="cuda")
            mask = (torch.arange(sk, device="cuda")[None, :]
                    >= lengths[:, None])[:, None, None, :].expand(
                shape[0], 1, sq, sk).clone()
            mask[-1, 0, 7, :] = True               # a fully masked row
        sm = FusedScaleMaskSoftmax(input_in_bf16=True, attn_mask_type=kind,
                                   scale=scale)
        out = sm(x, mask)
        ref = torch.softmax((x.float() * scale).masked_fill(mask, -10000.0),
                            dim=-1)
        worst[what] = bf16_ulps(torch, out, ref)
        check(out.dtype == torch.bfloat16 and worst[what] <= 1.0,
              f"transformer_ops: FusedScaleMaskSoftmax {what}: "
              f"{worst[what]:.3g} bf16 ulps from an fp32 softmax")
        if kind == AttnMaskType.padding:
            row = out[-1, :, 7].float()
            check(bool((row == 1.0 / sk).all()),
                  "transformer_ops: a fully masked row is not uniform")
        del x, mask, out, ref
    torch.cuda.empty_cache()

    # apex's MLP test sizes, card against CPU at fp32
    rng = np.random.RandomState(23)
    x = torch.from_numpy(rng.randn(MLP_BATCH, MLP_SIZES[0]).astype(
        np.float32))
    w = torch.from_numpy(rng.randn(MLP_BATCH, MLP_SIZES[-1]).astype(
        np.float32))
    mlp_state = MLP(MLP_SIZES, device="cpu").init(
        torch.Generator().manual_seed(0)).state_dict()
    mlp_err = {}
    for activation in ("relu", "sigmoid"):
        mlp_runs = []
        for device in ("cuda", "cpu"):
            mlp = MLP(MLP_SIZES, activation=activation, device=device)
            mlp.load_state_dict(mlp_state)
            xd = x.to(device).clone().requires_grad_()
            out = mlp(xd)
            (out * w.to(device)).sum().backward()
            mlp_runs.append([out.detach().cpu(), xd.grad.cpu()]
                            + [p.grad.cpu() for p in mlp.parameters()])
        errs = [float((a - b).norm() / b.norm().clamp(min=1e-30))
                for a, b in zip(*mlp_runs)]
        mlp_err[activation] = (errs[0], max(errs[1:]))
    check(max(mlp_err["relu"][0], *mlp_err["sigmoid"]) <= TOL_MLP,
          f"transformer_ops: MLP card vs CPU (output, worst grad) {mlp_err}")
    print(f"transformer_ops: FusedScaleMaskSoftmax bf16 against an fp32 "
          f"softmax, worst |diff| in bf16 ulps of the fp32 value {worst} "
          f"(tol 1), the fully masked row uniform; MLP{list(MLP_SIZES)} at "
          f"batch {MLP_BATCH}, fp32, card vs CPU, relative norms (output, "
          f"worst grad): {mlp_err} (tol {TOL_MLP} but the ReLU grads) "
          f"[{card}]")
    return launches


# ---------------------------------------------------------------------------
# phase 8: long-context attention (packed documents, a learned ALiBi bias)
# ---------------------------------------------------------------------------

def long_inputs(torch, seed: int = 0):
    """``bench.py::bench_flash_long``'s q, k, v and dy (``RandomState(0)``,
    bf16 on the card; another ``seed`` for other inputs) and, from the same
    stream after them, four packed documents a row as int32 segment ids;
    the ALiBi slopes' start."""
    import numpy as np
    b, h, s, d = LONG_SHAPE
    rng = np.random.RandomState(seed)
    q, k, v, dy = (torch.from_numpy(rng.randn(b, h, s, d)).to(
        "cuda", torch.bfloat16) for _ in range(4))
    ids = packed_ids(torch, rng, b, s, LONG_DOCS)
    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / h) for i in range(h)],
                          dtype=torch.float32, device="cuda")
    return q, k, v, dy, ids, slopes


def alibi(torch, slopes, s: int):
    """ALiBi as a learned causal row bias ``(1, h, 1, s)``: ``slope_h * j``
    (the ``-slope_h * i`` term of ``-slope_h (i - j)`` is constant along a
    row, and softmax drops it)."""
    pos = torch.arange(s, device=slopes.device, dtype=torch.float32)
    return slopes.view(1, -1, 1, 1) * pos.view(1, 1, 1, s)


def check_long_kernels(torch, fa, kern, card: str, q, k, v, dy, ids,
                       slopes) -> dict:
    """The four flash kernels at the long-context path's shape (96 x 4096
    x 4096, d 64, causal, the packed ids, the ALiBi row at its start)
    against their plain versions batch by batch (out, lse, dQ, dK and dV
    are per batch; dbias is the plain per-batch sums added in batch order
    in fp32) and the dbias folded into ``flash_bwd_dkv`` (repeated bit for
    bit, its dK/dV equal to the unfolded launch's), then ``flash_dbias`` at
    a ``(1, 12, 4096, 4096)`` relative-position table (its ``sqb == sq``
    branch at full size), each dbias launch repeated bit for bit. Returns
    the max abs errors."""
    b, h, s, d = LONG_SHAPE
    scale = d ** -0.5
    q3, k3, v3, do3 = (t.reshape(b * h, s, d) for t in (q, k, v, dy))
    bias = alibi(torch, slopes, s)
    segs = (ids, ids)
    out_k, lse_k = kern.flash_fwd(q3, k3, v3, True, scale, bias=bias,
                                  segments=segs)
    lse_p, delta_p = torch.empty_like(lse_k), torch.empty_like(lse_k)
    share = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0,
             "flash_dbias": 0.0, "flash_dbias_fold": 0.0}
    err = dict.fromkeys(share, 0.0)

    def note(kname, reading):
        err[kname] = max(err[kname], reading[0])
        share[kname] = max(share[kname], reading[1])

    def batch(i):
        rows = slice(i * h, (i + 1) * h)
        return rows, (ids[i:i + 1], ids[i:i + 1])

    tol = BF16_TOL
    for i in range(b):
        rows, seg_i = batch(i)
        out_p, lse_p[rows] = fa._flash_fwd_plain(
            q3[rows], k3[rows], v3[rows], True, scale, bias=bias,
            segments=seg_i)
        delta_p[rows] = (do3[rows].float() * out_p.float()).sum(dim=-1)
        note("flash_fwd", close(torch, [(out_k[rows], out_p)], tol, fwd_slack(
            torch, fa, q3[rows], k3[rows], v3[rows], True, scale, bias=bias)))
        compare_lse(torch, lse_k[rows], lse_p[rows], TOL_LSE,
                    f"flash_fwd long-context batch {i}", TOL_LSE_REL)
    same_bits(torch, "flash_fwd long-context", (out_k, lse_k), kern.flash_fwd(
        q3, k3, v3, True, scale, bias=bias, segments=segs))
    args = (q3, k3, v3, do3, lse_p, delta_p, True, scale)
    kw = dict(bias=bias, segments=segs)
    dq_k = kern.flash_bwd_dq(*args, **kw)
    same_bits(torch, "flash_bwd_dq long-context", (dq_k,),
              (kern.flash_bwd_dq(*args, **kw),))
    retaken(torch, kern, "the long-context shape (96 x 4096 x 4096, ids, "
            "ALiBi row)", args, kw, visible_pairs(torch, ids, ids, True, h),
            dq_k)
    dk_k, dv_k = kern.flash_bwd_dkv(*args, **kw)
    same_bits(torch, "flash_bwd_dkv long-context", (dk_k, dv_k),
              kern.flash_bwd_dkv(*args, **kw))
    db_k = kern.flash_dbias(*args, **kw)
    check(torch.equal(db_k, kern.flash_dbias(*args, **kw)),
          "flash_dbias long-context: a second launch differs")
    db_p = torch.zeros_like(db_k)
    for i in range(b):
        rows, seg_i = batch(i)
        args_i = (q3[rows], k3[rows], v3[rows], do3[rows], lse_p[rows],
                  delta_p[rows], True, scale)
        kw_i = dict(bias=bias, segments=seg_i)
        note("flash_bwd_dq", close(torch, [(
            dq_k[rows], fa._flash_bwd_dq_plain(*args_i, **kw_i))], tol))
        dk_p, dv_p = fa._flash_bwd_dkv_plain(*args_i, **kw_i)
        note("flash_bwd_dkv", close(torch, [(dk_k[rows], dk_p),
                                            (dv_k[rows], dv_p)], tol))
        db_p += fa._flash_dbias_plain(*args_i, **kw_i)
    torch.cuda.synchronize()
    note("flash_dbias", dbias_close(torch, db_k, db_p, "long-context"))
    note("flash_dbias_fold", check_fold_case(torch, fa, kern, "long-context",
                                             args, bias, segs, db_p))
    for kname in share:
        check(share[kname] <= 1, f"{kname} long-context: {share[kname]:.3g}"
                                 " x the limit")
    print(f"long-context kernels vs plain, batch by batch (96 x 4096 x 4096,"
          f" d64, causal, 4 packed documents a row, ALiBi row bias, bf16): "
          f"max_abs_err, share of the limit: " + ", ".join(
              f"{kname} {err[kname]:.3g}, {share[kname]:.3g}"
              for kname in share) + "; a second launch of each equal bit "
          f"for bit, the folded launch's dK/dV equal to the unfolded "
          f"launch's [{card}]")
    del dq_k, dk_k, dv_k, out_k

    # the relative-position table (1, 12, 4096, 4096), on the path's inputs
    gen = torch.Generator(device="cuda").manual_seed(9)
    table = torch.randn((1, h, s, s), generator=gen, device="cuda")
    out_t, lse_t = kern.flash_fwd(q3, k3, v3, True, scale, bias=table,
                                  segments=segs)
    delta_t = (do3.float() * out_t.float()).sum(dim=-1)
    del out_t
    args = (q3, k3, v3, do3, lse_t, delta_t, True, scale)
    db_k = kern.flash_dbias(*args, bias=table, segments=segs)
    check(torch.equal(db_k, kern.flash_dbias(*args, bias=table,
                                             segments=segs)),
          "flash_dbias (1, 12, 4096, 4096): a second launch differs")
    db_p = torch.zeros_like(db_k)
    for i in range(b):
        rows, seg_i = batch(i)
        db_p += fa._flash_dbias_plain(
            q3[rows], k3[rows], v3[rows], do3[rows], lse_t[rows],
            delta_t[rows], True, scale, bias=table, segments=seg_i)
    t_err, t_share = dbias_close(torch, db_k, db_p, "(1, 12, 4096, 4096)")
    table_ms = event_ms(torch, lambda: kern.flash_dbias(
        *args, bias=table, segments=segs))
    print(f"flash_dbias (1, 12, 4096, 4096) relative-position table on the "
          f"path's inputs: max_abs_err {t_err:.3g}, {t_share:.3g} x the "
          f"limit; a second launch equal bit for bit; kernel {table_ms:.4f} "
          f"ms [{card}]")
    del table, db_k, db_p
    torch.cuda.empty_cache()
    return err


def check_long_fold(torch, fa, kern, card: str, what: str, q, k, v, dy,
                    ids, slopes) -> tuple:
    """The dbias folded into ``flash_bwd_dkv`` at the long-context shape
    on other inputs than :func:`check_long_kernels`' (``what`` says which)
    against the plain version batch by batch, under ``DBIAS_TOL``, as
    :func:`check_fold_case` holds it (lse and delta from the kernel's
    forward, the same for both). Returns (max abs error, share of the
    limit)."""
    b, h, s, d = LONG_SHAPE
    scale = d ** -0.5
    q3, k3, v3, do3 = (t.reshape(b * h, s, d) for t in (q, k, v, dy))
    bias = alibi(torch, slopes, s)
    segs = (ids, ids)
    out, lse = kern.flash_fwd(q3, k3, v3, True, scale, bias=bias,
                              segments=segs)
    delta = (do3.float() * out.float()).sum(dim=-1)
    del out
    args = (q3, k3, v3, do3, lse, delta, True, scale)
    want = torch.zeros(bias.shape, device="cuda")
    for i in range(b):
        rows = slice(i * h, (i + 1) * h)
        want += fa._flash_dbias_plain(*(t[rows] for t in args[:6]), True,
                                      scale, bias=bias,
                                      segments=(ids[i:i + 1], ids[i:i + 1]))
    err, share = check_fold_case(torch, fa, kern, f"long-context, {what}",
                                 args, bias, segs, want)
    print(f"flash_dbias folded into flash_bwd_dkv at the long-context shape,"
          f" {what} (ALiBi row up to {float(bias.abs().max()):.1f}): "
          f"max_abs_err {err:.3g}, {share:.3g} x the limit; a second folded "
          f"launch equal bit for bit, its dK/dV equal to the unfolded "
          f"launch's [{card}]")
    del want, args, lse, delta
    torch.cuda.empty_cache()
    return err, share


def time_long_kernels(torch, fa, kern, card: str, q, k, v, dy, ids,
                      slopes) -> dict:
    """Device times (CUDA events, see :func:`event_ms`) of the four flash
    kernels at the long-context path's shape with its ids and bias, of
    their plain versions batch by batch, of
    the library calls (SDPA causal, SDPA with the packed causal mask as a
    boolean mask, and SDPA's backward with a float mask that takes a
    gradient), and the bounds over the pairs the ids leave visible.
    Returns the ``flash_dbias`` row of the kernels line and the times of
    the kernels a step launches. B6's row is the fold as the path runs it: the folded
    ``flash_bwd_dkv`` launch (dK, dV and the dbias partials; timed twice,
    in turns with the unfolded one) and the second pass alone on the
    path's partials. Its bound is the unfolded launch's work plus the
    partials' bytes and one fp32 add a visible score, its plain time the
    plain dK/dV and dbias, its library call SDPA's backward with a float
    mask's gradient (which computes dQ too); beside it the standalone
    ``flash_dbias`` and the fold's added time."""
    b, h, s, d = LONG_SHAPE
    scale = d ** -0.5
    q3, k3, v3, do3 = (t.reshape(b * h, s, d) for t in (q, k, v, dy))
    bias = alibi(torch, slopes, s)
    segs = (ids, ids)
    out, lse = kern.flash_fwd(q3, k3, v3, True, scale, bias=bias,
                              segments=segs)
    delta = (do3.float() * out.float()).sum(dim=-1)
    args = (q3, k3, v3, do3, lse, delta, True, scale)
    kw = dict(bias=bias, segments=segs)
    kernel = {
        "flash_fwd": lambda: kern.flash_fwd(q3, k3, v3, True, scale, **kw),
        "flash_bwd_dq": lambda: kern.flash_bwd_dq(*args, **kw),
        "flash_bwd_dkv": lambda: kern.flash_bwd_dkv(*args, **kw),
        "flash_dbias": lambda: kern.flash_dbias(*args, **kw)}
    plain_fn = {"flash_fwd": fa._flash_fwd_plain,
                "flash_bwd_dq": fa._flash_bwd_dq_plain,
                "flash_bwd_dkv": fa._flash_bwd_dkv_plain,
                "flash_dbias": fa._flash_dbias_plain}

    def batched(fn, fwd):
        def call():
            for i in range(b):
                rows = slice(i * h, (i + 1) * h)
                seg_i = (ids[i:i + 1], ids[i:i + 1])
                lead = ((q3[rows], k3[rows], v3[rows], True, scale) if fwd
                        else (q3[rows], k3[rows], v3[rows], do3[rows],
                              lse[rows], delta[rows], True, scale))
                fn(*lead, bias=bias, segments=seg_i)
        return call

    ms = {name: event_ms(torch, fn) for name, fn in kernel.items()}
    plain = {name: event_ms(torch, batched(fn, name == "flash_fwd"), 1)
             for name, fn in plain_fn.items()}
    # the fold: dkv without and with it, in turns, 10 launches each time
    turns = {False: [], True: []}
    for fold in (False, True, True, False):
        turns[fold].append(event_ms(torch, lambda: kern.flash_bwd_dkv(
            *args, **kw, need_dbias=fold), 10))
    dkv_ms, fold_ms = (sum(turns[f]) / 2 for f in (False, True))
    lib_k, _ = kern.build()
    split = kern._dbias_split(bias, b * h)
    part = torch.randn((b * h, s), device="cuda")
    db = torch.empty(bias.shape, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    second_ms = event_ms(torch, lambda: kern._dbias_fold_sum(
        lib_k, part, db, split, stream), 10)
    del part, db
    fused_ms = fold_ms + second_ms
    print(f"flash_dbias folded into flash_bwd_dkv at the long-context shape:"
          f" dkv {dkv_ms:.4f} ms without the fold, {fold_ms:.4f} ms with it "
          f"(turns: {', '.join(f'{t:.4f}' for t in turns[False])} / "
          f"{', '.join(f'{t:.4f}' for t in turns[True])}), the second pass "
          f"alone {second_ms:.4f} ms ({split[1]} partial rows a slice): the "
          f"fold as the path runs it {fused_ms:.4f} ms (dK, dV and dbias), "
          f"{fused_ms - dkv_ms:.4f} ms more than dK/dV alone; the standalone "
          f"flash_dbias {ms['flash_dbias']:.4f} ms [{card}]")
    # library yardsticks: the port never calls them
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pos = torch.arange(s, device="cuda")
    packed = ((ids[:, None, :, None] == ids[:, None, None, :])
              & (pos[None, :] <= pos[:, None]))            # (8, 1, s, s)
    lib = {}
    lib["causal fwd"] = event_ms(torch, lambda: sdpa(q, k, v,
                                                     is_causal=True), 10)
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    o = sdpa(qg, kg, vg, is_causal=True)
    lib["causal bwd"] = event_ms(torch, lambda: torch.autograd.grad(
        o, (qg, kg, vg), dy, retain_graph=True), 10)
    lib["packed fwd"] = event_ms(torch, lambda: sdpa(q, k, v,
                                                     attn_mask=packed), 5)
    o = sdpa(qg, kg, vg, attn_mask=packed)
    lib["packed bwd"] = event_ms(torch, lambda: torch.autograd.grad(
        o, (qg, kg, vg), dy, retain_graph=True), 5)
    del o
    # B6's yardstick: SDPA's backward with a float mask (the ALiBi row and
    # the packed causal mask, (8, 12, 4096, 4096) bf16) that takes a grad
    mask = bias.to(torch.bfloat16).expand(b, h, s, s).masked_fill(
        ~packed, float("-inf")).requires_grad_()
    try:
        o = sdpa(qg, kg, vg, attn_mask=mask)
        lib["mask grad bwd"] = event_ms(torch, lambda: torch.autograd.grad(
            o, (qg, kg, vg, mask), dy, retain_graph=True))
        del o
    except RuntimeError as exc:
        lib["mask grad bwd"] = None
        print(f"SDPA backward with a float mask's grad: no backend returned "
              f"it ({str(exc).splitlines()[0][:200]})")
    del qg, kg, vg, mask, packed
    torch.cuda.empty_cache()
    pairs = visible_pairs(torch, ids, ids, True, h)
    causal_pairs = b * h * (s * (s + 1) // 2)
    tile, rows_b = nbytes_of(q), b * h * s * 4
    extra = nbytes_of(bias, ids)           # the bias row and the ids
    work = {  # bytes (inputs read once, outputs written once), operations
        "flash_fwd": (4 * tile + rows_b + extra, 4 * d * pairs),
        "flash_bwd_dq": (5 * tile + 2 * rows_b + extra, 6 * d * pairs),
        "flash_bwd_dkv": (6 * tile + 2 * rows_b + extra, 8 * d * pairs),
        "flash_dbias": (4 * tile + 2 * rows_b + 2 * nbytes_of(bias)
                        + nbytes_of(ids), 4 * d * pairs)}
    library = {"flash_fwd": lib["packed fwd"],
               "flash_bwd_dq": lib["packed bwd"],
               "flash_bwd_dkv": lib["packed bwd"],
               "flash_dbias": lib["mask grad bwd"]}
    share_seen = pairs / causal_pairs
    computed, causal_tiles, all_tiles = tile_shares(torch, fa, ids, True)
    print(f"long-context tiles (64 x 64, a batch row's): the tensor-core "
          f"kernels compute {computed} of the {causal_tiles} causal tile "
          f"pairs ({computed / causal_tiles:.4f}; _tiles_meet on the ids), "
          f"beside the {share_seen:.4f} of causal pairs the ids leave "
          f"visible; causal tile pairs are {causal_tiles / all_tiles:.4f} "
          f"of all {all_tiles}")
    print(f"long-context shape: {pairs} visible pairs ({share_seen:.4f} of "
          f"the {causal_pairs} causal ones); SDPA causal fwd "
          f"{lib['causal fwd']:.4f} ms, bwd {lib['causal bwd']:.4f} ms; SDPA "
          f"with the packed causal mask as a bool (8, 1, 4096, 4096) mask fwd"
          f" {lib['packed fwd']:.4f} ms, bwd {lib['packed bwd']:.4f} ms; SDPA "
          f"backward with the float mask's grad "
          + ("none" if lib["mask grad bwd"] is None
             else f"{lib['mask grad bwd']:.4f} ms") + f" [{card}]")
    bounds = {}
    for kname in kernel:
        bounds[kname] = bound(*work[kname])
        print(f"{kname} long-context timing (96 x 4096 x 4096, d64, causal, "
              f"ids, ALiBi row, bf16): kernel {ms[kname]:.4f} ms, plain "
              f"(8 batches) {plain[kname]:.4f} ms, library "
              + ("none" if library[kname] is None
                 else f"{library[kname]:.4f} ms") + f", bound "
              f"{bounds[kname][0]:.5f} ms ({bounds[kname][1]}; "
              f"{work[kname][0] / 1e6:.1f} MB, {work[kname][1] / 1e9:.2f} "
              f"GFLOP) [{card}]")
    del out, lse, delta
    torch.cuda.empty_cache()
    # the fold as the path runs it: dK/dV's work, the partials written and
    # read, dbias written, and one fp32 add a visible score
    fold_bytes = (work["flash_bwd_dkv"][0] + 2 * b * h * s * 4
                  + 4 * bias.numel())
    b_ms, b_by = bound(fold_bytes, work["flash_bwd_dkv"][1], pairs)
    fold_plain = plain["flash_bwd_dkv"] + plain["flash_dbias"]
    print(f"flash_dbias folded into flash_bwd_dkv, long-context timing: "
          f"{fused_ms:.4f} ms, plain dK/dV and dbias (8 batches) "
          f"{fold_plain:.4f} ms, library (SDPA backward with the float "
          f"mask's grad, dQ included) "
          + ("none" if library["flash_dbias"] is None
             else f"{library['flash_dbias']:.4f} ms") + f", bound {b_ms:.5f}"
          f" ms ({b_by}; {fold_bytes / 1e6:.1f} MB, "
          f"{work['flash_bwd_dkv'][1] / 1e9:.2f} GFLOP bf16, "
          f"{pairs / 1e9:.3f} GFLOP fp32) [{card}]")
    # what a step runs: the forward, dQ, and dK/dV with the fold
    step_ms = {"flash_fwd": ms["flash_fwd"],
               "flash_bwd_dq": ms["flash_bwd_dq"],
               "flash_bwd_dkv with the fold": fused_ms}
    return {"name": "flash_dbias", "route": "cuda",
            "source": "apex_tpu_torch/csrc/flash_bwd.cu",
            "replaces": REPLACES["flash_dbias"], "ms": fused_ms,
            "plain_ms": fold_plain, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library["flash_dbias"]}, step_ms


def long_trainer(torch, fa, q, k, v, dy, ids, slopes0, use_kernel: bool):
    """A step of the long-context path: ``flash_attention`` with the ALiBi
    row of the slopes, the ids, causal; the loss ``sum(out * dy)``;
    backward; ``FusedAdam`` on the slopes. The kernel path runs the whole
    batch in one call, the plain path batch by batch (the slopes' grad
    summed over the batches in order). ``step(start)`` first sets the
    slopes to ``start`` if given, and returns ``(loss, sum |out * dy|,
    (dq, dk, dv), the slopes' grad, the slopes after the step)``."""
    from apex_tpu_torch.optimizers import FusedAdam
    b, s = q.shape[0], q.shape[2]
    slopes = slopes0.clone().requires_grad_()
    opt = FusedAdam(lr=LONG_LR)
    state = opt.init({"slopes": slopes})
    parts = [slice(0, b)] if use_kernel else [slice(i, i + 1)
                                              for i in range(b)]

    def step(start=None):
        if start is not None:
            with torch.no_grad():
                slopes.copy_(start)
        slopes.grad = None
        loss, l1, grads = 0.0, 0.0, ([], [], [])
        for part in parts:
            leaves = [t[part].detach().requires_grad_() for t in (q, k, v)]
            out = fa.flash_attention(
                *leaves, bias=alibi(torch, slopes, s), causal=True,
                bias_requires_grad=True, segment_ids=ids[part],
                use_kernel=use_kernel)
            terms = out.float() * dy[part].float()
            part_loss = terms.sum()
            part_loss.backward()
            loss = loss + part_loss.detach()
            l1 = l1 + terms.detach().abs().sum()
            for acc, t in zip(grads, leaves):
                acc.append(t.grad)
        g = slopes.grad.detach().clone()
        opt.step({"slopes": slopes.grad}, state, {"slopes": slopes})
        return (loss, l1, [torch.cat(x) for x in grads], g,
                slopes.detach().clone())
    return step


def compare_long(torch, kernel_run, plain_run) -> dict:
    """The worst, over the steps, of the loss difference over ``sum |out
    * dy|``, the relative norm of dQ/dK/dV, that of the slopes' grad, and
    the largest difference of the slopes after a step."""
    worst = dict.fromkeys(("loss", "dqkv", "grad", "slopes"), 0.0)
    for (k_loss, _, k_grads, k_g, k_sl), (loss, l1, grads, g, sl) in zip(
            kernel_run, plain_run):
        worst["loss"] = max(worst["loss"], float((k_loss - loss).abs() / l1))
        worst["dqkv"] = max(worst["dqkv"], max(
            float((a.float() - w.float()).norm() / w.float().norm())
            for a, w in zip(k_grads, grads)))
        worst["grad"] = max(worst["grad"],
                            float((k_g - g).norm() / g.norm()))
        worst["slopes"] = max(worst["slopes"],
                              float((k_sl - sl).abs().max()))
    return worst


def long_context(torch, fa, kern, card: str):
    """The long-context path (see the module docstring): the kernels at
    its shape, the fold on other seeds' inputs and under steeper slopes,
    then ``LONG_STEPS`` steps of forward, backward and
    ``FusedAdam`` on the ALiBi slopes through ``flash_attention`` on the
    kernels, each launching each of the four flash kernels once; the plain
    path batch by batch from the kernel path's slopes at each step (bf16:
    loss, dQ/dK/dV; then the fold with the trained slopes); the same path in fp32, kernel and plain trajectories
    each on their own (loss, dQ/dK/dV, the slopes' grad and the slopes);
    then ``bench_flash_long``'s own call (no bias, no ids). Returns the
    launch counts of the bf16 kernel path's steps and the ``flash_dbias``
    row (B6 there being the fold, its launches counted as
    ``flash_dbias_fold``)."""
    b, h, s, d = LONG_SHAPE
    q, k, v, dy, ids, slopes0 = long_inputs(torch)
    errs = check_long_kernels(torch, fa, kern, card, q, k, v, dy, ids,
                              slopes0)
    row, kernel_ms = time_long_kernels(torch, fa, kern, card, q, k, v, dy,
                                       ids, slopes0)
    # the fold on other inputs: other seeds' q, k, v, dy and ids, the
    # path's inputs under steeper slopes (here), and the path's inputs with
    # the slopes its steps trained (below)
    fold_errs = []
    for seed in LONG_FOLD_SEEDS:
        fold_errs.append(check_long_fold(
            torch, fa, kern, card, f"seed {seed}'s inputs",
            *long_inputs(torch, seed))[0])
    for times in LONG_FOLD_STEEPER:
        fold_errs.append(check_long_fold(
            torch, fa, kern, card, f"slopes x {times}", q, k, v, dy, ids,
            times * slopes0)[0])
    row["max_abs_err"] = max(errs["flash_dbias"], errs["flash_dbias_fold"])
    want = {name: 0 for name in kern.LAUNCHES}
    want.update(flash_fwd=1, flash_bwd_dq=1, flash_bwd_dkv=1)
    # the learned row bias's gradient: folded into flash_bwd_dkv in bf16,
    # flash_dbias in fp32 (_kernels.dbias_folds)
    wants = {"bf16": dict(want, flash_dbias_fold=1),
             "fp32": dict(want, flash_dbias=1)}

    def run_kernel_path(tensors, what):
        want = wants[what]
        step = long_trainer(torch, fa, *tensors, ids, slopes0, True)
        launches = {name: 0 for name in kern.LAUNCHES}
        run, times = [], []
        for i in range(LONG_STEPS):
            torch.cuda.synchronize()
            kern.reset_launches()
            t0 = time.perf_counter()
            result = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            counts = dict(kern.LAUNCHES)
            check(counts == want, f"long-context {what} step {i}: launches "
                                  f"{counts}, want {want}")
            check(bool(torch.isfinite(result[0])) and all(
                bool(torch.isfinite(g).all())
                for g in result[2] + [result[3]]),
                f"long-context {what} step {i}: loss or grads not finite")
            for name, n in counts.items():
                launches[name] += n
            run.append(result)
            print(f"long-context {what} step {i}: loss "
                  f"{float(result[0]):.4f}, slopes' grad "
                  f"{[round(x, 3) for x in result[3].tolist()]}, "
                  f"{1e3 * times[-1]:.3f} ms (host clock, synchronized), "
                  f"launches {counts} [{card}]")
        return step, run, times, launches

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, kernel_run, times, launches = run_kernel_path((q, k, v, dy),
                                                        "bf16")
    steady = sorted(times)[len(times) // 2]
    print(f"long-context: 8 x 4096 tokens, 4 packed documents a row, ALiBi "
          f"slopes trained by FusedAdam(lr={LONG_LR}): median step "
          f"{1e3 * steady:.3f} ms, {b * s / steady:.1f} tokens/s; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"the event times of the kernels a step launches (flash_fwd, "
          f"flash_bwd_dq, flash_bwd_dkv with the fold and its second pass) "
          f"sum to "
          f"{sum(kernel_ms.values()):.3f} ms, "
          f"{100 * sum(kernel_ms.values()) / (1e3 * steady):.1f}% of the "
          f"step [{card}]")
    profile_step(torch, "long-context step (8 x 4096 tokens)", step, card,
                 iters=3)
    del step
    fold_errs.append(check_long_fold(
        torch, fa, kern, card, f"the slopes after {LONG_STEPS} steps", q, k,
        v, dy, ids, kernel_run[-1][4])[0])
    row["max_abs_err"] = max([row["max_abs_err"]] + fold_errs)

    # bf16: the plain path from the kernel path's slopes before each step
    plain = long_trainer(torch, fa, q, k, v, dy, ids, slopes0, False)
    kern.reset_launches()
    plain_run = [plain(slopes0 if i == 0 else kernel_run[i - 1][4])
                 for i in range(LONG_STEPS)]
    check(sum(kern.LAUNCHES.values()) == 0,
          "the plain long-context path launched kernels")
    bf16 = compare_long(torch, kernel_run, plain_run)
    for what, lim in (("loss", TOL_LONG_LOSS), ("dqkv", TOL_LONG_DQKV)):
        check(bf16[what] <= lim, f"long-context bf16 kernel vs plain path: "
                                 f"{what} {bf16[what]:.3g} > {lim}")
    print(f"long-context bf16: kernel path vs plain path (batch by batch, "
          f"from the kernel path's slopes at each step) over {LONG_STEPS} "
          f"steps: |loss diff| / sum |out * dy| {bf16['loss']:.3g} (tol "
          f"{TOL_LONG_LOSS}); dQ/dK/dV relative norm {bf16['dqkv']:.3g} (tol "
          f"{TOL_LONG_DQKV}); the slopes' grad relative norm "
          f"{bf16['grad']:.3g}, not held in bf16 (see LONG_TOL_FP32); "
          f"plain-path slopes' grads "
          f"{[[round(x, 3) for x in r[3].tolist()] for r in plain_run]}")
    del plain, plain_run, kernel_run
    torch.cuda.empty_cache()

    # fp32: the same path and inputs, each trajectory on its own
    f32 = tuple(t.float() for t in (q, k, v, dy))
    _, kernel_run, _, _ = run_kernel_path(f32, "fp32")
    plain = long_trainer(torch, fa, *f32, ids, slopes0, False)
    kern.reset_launches()
    plain_run = [plain() for _ in range(LONG_STEPS)]
    check(sum(kern.LAUNCHES.values()) == 0,
          "the plain long-context path launched kernels")
    fp32 = compare_long(torch, kernel_run, plain_run)
    for what, lim in LONG_TOL_FP32.items():
        check(fp32[what] <= lim, f"long-context fp32 kernel vs plain path: "
                                 f"{what} {fp32[what]:.3g} > {lim}")
    print(f"long-context fp32: kernel path vs plain path (batch by batch), "
          f"{LONG_STEPS} steps each on its own: " + ", ".join(
              f"{what} {fp32[what]:.3g} (tol {lim})"
              for what, lim in LONG_TOL_FP32.items())
          + f"; plain-path slopes after each step "
          f"{[[round(x, 6) for x in r[4].tolist()] for r in plain_run]} "
          f"[{card}]")
    del plain, plain_run, kernel_run, f32
    torch.cuda.empty_cache()

    # bench.py::bench_flash_long's own call: causal, no bias, no ids
    def bench_step():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fa.flash_attention(*leaves, causal=True)
        (out.float() * dy.float()).sum().backward()

    torch.cuda.synchronize()
    kern.reset_launches()
    bench_step()
    torch.cuda.synchronize()
    counts = dict(kern.LAUNCHES)
    check(counts == want, f"bench_flash_long step: launches {counts}, want "
                          f"{want}")
    bench_ms = 1e3 * _host_time(torch, bench_step, 3)
    print(f"flash_attention_seq4096_fwd_bwd_ms {bench_ms:.3f} (bench_flash_"
          f"long's call: 8 x 12 x 4096, d64, causal, bf16, forward and "
          f"backward through flash_attention on the kernels; host clock, "
          f"mean of 3 synchronized steps) [{card}]")
    profile_step(torch, "bench_flash_long step (fwd + bwd)", bench_step,
                 card, iters=3)
    del q, k, v, dy
    torch.cuda.empty_cache()
    return launches, row


# MLPerf Training's RNN-T (mlcommons/training
# rnn_speech_recognition/pytorch, configs/baseline_v3-1023sp.yaml): 240
# input features (80 filterbanks spliced by 3), an encoder of 2 LSTM
# layers of 1024, a time stacking by 2, then 3 LSTM layers of 1024; a
# prediction network of a 512 embedding over the 1023 sentence pieces and
# the blank (last), then 2 LSTM layers of 512; the joint's two projections
# to 512, ReLU, a linear to 1024 classes. Batch 16, 534 frames (~16 s of
# audio after the splicing), 125 labels a row; f_len and y_len drawn from
# the seed between half and full
RNNT = dict(features=240, enc=1024, pre_layers=2, stack=2, post_layers=3,
            pred=512, pred_layers=2, joint=512, classes=1024, batch=16,
            frames=534, labels=125)
RNNT_STEPS = 3
RNNT_LR = 1e-3
# the card-vs-CPU legs of the RNN-T phase, at a size the CPU runs quickly
RNNT_SMALL = dict(batch=2, frames=30, labels=10, classes=16)
RNNT_LSTM_SMALL = (20, 3, 32, 64)          # T, B, input, hidden
TOL_CARD_CPU = 1e-5     # fp32 on both: the same ops, sums in other orders
# bf16 compute against fp32 compute from the same weights: h and c are
# rounded to bf16 every step (534 + 267 + 126 steps deep) and the joint's
# activations once. At random init the loss is the log-softmax over
# near-uniform logits, which bf16 barely moves: within 1e-4 relative
# (the first H100 run of this check read 3.2e-7); each grad leaf within
# 5% by relative norm (read: 0.79%, the embedding)
TOL_RNNT_LOSS = 1e-4
TOL_RNNT_GRAD = 5e-2


def rnnt_model(torch, cfg: dict, device: str, seed: int = 0):
    """The RNN-T model as ``nn.Module`` parameters on ``device``, drawn
    from ``seed`` on the host: ``LSTM``s of :mod:`apex_tpu_torch.RNN`
    (uniform in +-1/sqrt(hidden)), the embedding N(0, 1), the projections
    uniform in +-1/sqrt(fan_in)."""
    from torch import nn
    from apex_tpu_torch.RNN import LSTM

    gen = torch.Generator().manual_seed(seed)
    m = nn.Module()
    m.pre = LSTM(cfg["features"], cfg["enc"], cfg["pre_layers"],
                 device=device).init(gen)
    m.post = LSTM(cfg["enc"] * cfg["stack"], cfg["enc"], cfg["post_layers"],
                  device=device).init(gen)
    m.pred = LSTM(cfg["pred"], cfg["pred"], cfg["pred_layers"],
                  device=device).init(gen)

    def param(*shape, fan_in=None):
        if fan_in is None:
            vals = torch.randn(shape, generator=gen)
        else:
            bound = fan_in ** -0.5
            vals = torch.rand(shape, generator=gen) * (2 * bound) - bound
        return nn.Parameter(vals.to(device))

    m.embed = param(cfg["classes"], cfg["pred"])
    m.enc_w = param(cfg["joint"], cfg["enc"], fan_in=cfg["enc"])
    m.enc_b = param(cfg["joint"], fan_in=cfg["enc"])
    m.pred_w = param(cfg["joint"], cfg["pred"], fan_in=cfg["pred"])
    m.pred_b = param(cfg["joint"], fan_in=cfg["pred"])
    m.out_w = param(cfg["classes"], cfg["joint"], fan_in=cfg["joint"])
    m.out_b = param(cfg["classes"], fan_in=cfg["joint"])
    return m


def rnnt_batch(torch, cfg: dict, device: str, seed: int = 0):
    """Features ``(frames, batch, features)`` N(0, 1), labels in the
    pieces (never the blank), ``f_len`` (after the stacking) and ``y_len``
    between half and full, from ``RandomState(seed)``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b, t, u = cfg["batch"], cfg["frames"] // cfg["stack"], cfg["labels"]
    feats = rng.randn(cfg["frames"], b, cfg["features"]).astype(np.float32)
    labels = rng.randint(0, cfg["classes"] - 1, (b, u))
    f_len = rng.randint(t // 2, t + 1, b)
    y_len = rng.randint(u // 2, u + 1, b)
    f_len[0], y_len[0] = t, u
    return tuple(torch.from_numpy(a).to(device)
                 for a in (feats, labels, f_len, y_len))


def rnnt_logits(torch, m, cfg: dict, feats, labels, f_len, y_len, dtype):
    """The joint's fp32 logits ``(B, T, U + 1, classes)``: the encoder,
    the time stacking, the prediction network over the blank and the
    labels, both projections (fp32 products cast to ``dtype``),
    ``transducer_joint(relu=True)`` and the output linear (fp32
    products)."""
    from apex_tpu_torch.RNN import _linear
    from apex_tpu_torch.ops import transducer_joint

    x, _ = m.pre(feats.to(dtype))
    t, b, h = x.shape
    s = cfg["stack"]
    x = x.reshape(t // s, s, b, h).permute(0, 2, 1, 3).reshape(t // s, b,
                                                                s * h)
    enc, _ = m.post(x)
    blank = cfg["classes"] - 1
    tokens = torch.cat([torch.full_like(labels[:, :1], blank), labels], 1)
    g, _ = m.pred(m.embed[tokens].to(dtype).transpose(0, 1))
    f = _linear(enc.transpose(0, 1), m.enc_w, m.enc_b)
    gp = _linear(g.transpose(0, 1), m.pred_w, m.pred_b)
    joint = transducer_joint(f, gp, f_len, y_len + 1, relu=True)
    return torch.matmul(joint.float(), m.out_w.t()) + m.out_b


def rnnt_loss(torch, m, cfg, batch, dtype):
    from apex_tpu_torch.ops import transducer_loss
    feats, labels, f_len, y_len = batch
    logits = rnnt_logits(torch, m, cfg, feats, labels, f_len, y_len, dtype)
    return transducer_loss(logits, labels, f_len, y_len,
                           blank_idx=cfg["classes"] - 1).mean()


def rnnt_small_holds(torch, card: str) -> None:
    """The transducer loss (forward and closed-form backward) and one LSTM
    layer on the card against the CPU at a reduced size, fp32."""
    import numpy as np
    from apex_tpu_torch.ops import transducer_loss
    from apex_tpu_torch.RNN import LSTM

    cfg = dict(RNNT, **RNNT_SMALL)
    rng = np.random.RandomState(1)
    b, t, u, v = (cfg["batch"], cfg["frames"], cfg["labels"],
                  cfg["classes"])
    x = torch.from_numpy(rng.randn(b, t, u + 1, v).astype(np.float32))
    args = (torch.from_numpy(rng.randint(0, v - 1, (b, u))),
            torch.tensor([t, t // 2]), torch.tensor([u, u - 3]))
    w = torch.from_numpy(rng.randn(b).astype(np.float32))
    got = {}
    for dev in ("cuda", "cpu"):
        xx = x.to(dev).requires_grad_(True)
        loss = transducer_loss(xx, *(a.to(dev) for a in args),
                               blank_idx=v - 1)
        (loss * w.to(dev)).sum().backward()
        got[dev] = (loss.detach().cpu(), xx.grad.cpu())
    l_err = float((got["cuda"][0] - got["cpu"][0]).abs().max()
                  / got["cpu"][0].abs().max())
    g_err = float((got["cuda"][1] - got["cpu"][1]).abs().max()
                  / got["cpu"][1].abs().max())
    check(l_err <= TOL_CARD_CPU and g_err <= TOL_CARD_CPU,
          f"rnnt: transducer loss card vs CPU {l_err:.3g}, grad "
          f"{g_err:.3g} > {TOL_CARD_CPU}")
    T, B, I, H = RNNT_LSTM_SMALL
    xs = torch.from_numpy(rng.randn(T, B, I).astype(np.float32))
    runs = {}
    for dev in ("cuda", "cpu"):
        lstm = LSTM(I, H, 1, device=dev).init(
            torch.Generator().manual_seed(3))
        xx = xs.to(dev).requires_grad_(True)
        out, (h, c) = lstm(xx)
        (out.sum() + (c * c).sum()).backward()
        runs[dev] = [out.detach(), h.detach(), c.detach(), xx.grad] + [
            p.grad for p in lstm.parameters()]
    worst = max(float((a.cpu() - b).abs().max() / b.abs().max())
                for a, b in zip(runs["cuda"], runs["cpu"]))
    check(worst <= TOL_CARD_CPU, f"rnnt: LSTM layer card vs CPU {worst:.3g}"
                                 f" > {TOL_CARD_CPU}")
    print(f"rnnt: card vs CPU (fp32), transducer loss {b} x {t} x {u + 1} x "
          f"{v}: loss {l_err:.3g}, grad {g_err:.3g}; LSTM {I}->{H} over "
          f"{T} x {B}, outputs, states and grads {worst:.3g} (tol "
          f"{TOL_CARD_CPU}) [{card}]")


def rnnt(torch, kern, card: str) -> dict:
    """One RNN-T training step at MLPerf Training's widths (``RNNT``), bf16
    compute over fp32 params, ``FusedAdam``: ``RNNT_STEPS`` steps with
    finite losses, step ms, peak memory and a profile; the loss and
    step 0's grads against an fp32 run on the card; the transducer's
    forward and backward, the joint, and the encoder's first LSTM stack
    against cuDNN's ``nn.LSTM`` (a yardstick only); the small holds
    against the CPU. Returns the port-kernel launches of the steps (none:
    the RNN-T path is torch ops and cuBLAS GEMMs, as the reference leaves
    it to XLA)."""
    from apex_tpu_torch.ops import transducer_joint, transducer_loss
    from apex_tpu_torch.optimizers import FusedAdam

    cfg = RNNT
    rnnt_small_holds(torch, card)
    batch = rnnt_batch(torch, cfg, "cuda")
    model = rnnt_model(torch, cfg, "cuda")
    params = dict(model.named_parameters())
    opt = FusedAdam(lr=RNNT_LR)
    state = opt.init(params)

    def step():
        for p in params.values():
            p.grad = None
        loss = rnnt_loss(torch, model, cfg, batch, torch.bfloat16)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        out = (loss.detach(), {n: g.clone() for n, g in grads.items()})
        opt.step(grads, state, params)
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    losses, times = [], []
    for i in range(RNNT_STEPS):
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
        if i == 0:
            grads0 = grads
        del grads
    launches = dict(kern.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(v) for v in losses),
          f"rnnt: losses not finite {losses}")
    check(sum(launches.values()) == 0,
          f"rnnt: the RNN-T step launched the port's kernels {launches}")
    step_ms = 1e3 * min(times[1:])
    t_enc = cfg["frames"] // cfg["stack"]
    print(f"rnnt: MLPerf RNN-T step (batch {cfg['batch']}, {cfg['frames']} "
          f"frames -> T {t_enc}, U+1 {cfg['labels'] + 1}, {cfg['classes']} "
          f"classes, bf16 compute, fp32 params, FusedAdam): losses "
          f"{[round(v, 4) for v in losses]}, step {step_ms:.3f} ms (the "
          f"best of steps 1-{RNNT_STEPS - 1}; step 0 {1e3 * times[0]:.3f} "
          f"ms; host clock, synchronized), peak memory {peak:.3f} GiB "
          f"[{card}]")
    busy_ms, kernels = profile_step(torch, "rnnt step", step, card,
                                    iters=1, top=4)
    print(f"rnnt: one step's device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / step_ms:.1f}% of the unprofiled step's "
          f"{step_ms:.3f} ms, {kernels:.0f} device launches [{card}]")

    # step 0's loss and grads against fp32 compute from the same weights
    ref = rnnt_model(torch, cfg, "cuda")
    loss32 = rnnt_loss(torch, ref, cfg, batch, torch.float32)
    loss32.backward()
    loss32 = float(loss32.detach())
    l_err = abs(losses[0] - loss32) / abs(loss32)
    g_err, g_leaf = grad_rel(torch, grads0, {n: p.grad for n, p in
                                             ref.named_parameters()})
    del ref, grads0
    torch.cuda.empty_cache()
    check(l_err <= TOL_RNNT_LOSS, f"rnnt: bf16 loss vs fp32 {l_err:.3g} > "
                                  f"{TOL_RNNT_LOSS}")
    check(g_err <= TOL_RNNT_GRAD, f"rnnt: bf16 grads vs fp32, {g_leaf} "
                                  f"{g_err:.3g} > {TOL_RNNT_GRAD}")
    print(f"rnnt: step 0 bf16 vs fp32 on the card: loss {losses[0]:.6f} vs "
          f"{loss32:.6f}, relative {l_err:.4g} (tol {TOL_RNNT_LOSS});"
          f" grads, worst leaf {g_leaf}: {g_err:.4g} (tol {TOL_RNNT_GRAD})")

    # the transducer alone, on the step's logits
    feats, labels, f_len, y_len = batch
    with torch.no_grad():
        logits = rnnt_logits(torch, model, cfg, feats, labels, f_len, y_len,
                             torch.bfloat16)
    logits.requires_grad_(True)
    blank = cfg["classes"] - 1

    def loss_fwd():
        return transducer_loss(logits, labels, f_len, y_len, blank)

    def loss_fwd_bwd():
        logits.grad = None
        loss_fwd().sum().backward()

    fwd_host = 1e3 * _host_time(torch, loss_fwd, 2)
    both_host = 1e3 * _host_time(torch, loss_fwd_bwd, 2)
    fwd_dev = device_ms(torch, loss_fwd, iters=1)
    both_dev = device_ms(torch, loss_fwd_bwd, iters=1)
    f = torch.randn(cfg["batch"], t_enc, cfg["joint"], device="cuda",
                    dtype=torch.bfloat16)
    g = torch.randn(cfg["batch"], cfg["labels"] + 1, cfg["joint"],
                    device="cuda", dtype=torch.bfloat16)
    joint_ms = device_ms(torch, lambda: transducer_joint(
        f, g, f_len, y_len + 1, relu=True), iters=3)
    del logits, f, g
    torch.cuda.empty_cache()
    print(f"rnnt: transducer loss at {cfg['batch']} x {t_enc} x "
          f"{cfg['labels'] + 1} x {cfg['classes']} (fp32 logits, "
          f"{t_enc + cfg['labels']} anti-diagonals each way): forward "
          f"{fwd_host:.3f} ms host clock, {fwd_dev:.3f} ms device; forward "
          f"+ backward {both_host:.3f} ms host, {both_dev:.3f} ms device; "
          f"{100 * both_host / step_ms:.1f}% of the step's host time. The "
          f"joint (bf16, ReLU, lengths) {joint_ms:.4f} ms device [{card}]")

    # the encoder's first LSTM stack against cuDNN's nn.LSTM at its shape
    x = torch.randn(cfg["frames"], cfg["batch"], cfg["features"],
                    device="cuda", dtype=torch.bfloat16, requires_grad=True)
    cudnn = torch.nn.LSTM(cfg["features"], cfg["enc"], cfg["pre_layers"],
                          device="cuda", dtype=torch.bfloat16)

    def port_lstm():
        out, _ = model.pre(x)
        out.float().sum().backward()

    def cudnn_lstm():
        out, _ = cudnn(x)
        out.float().sum().backward()

    port_ms = 1e3 * _host_time(torch, port_lstm, 1)
    lib_ms = 1e3 * _host_time(torch, cudnn_lstm, 3)
    lib_dev = device_ms(torch, cudnn_lstm, iters=3)
    del x, cudnn
    print("rnnt: encoder's first LSTM stack (2 layers, 240 -> 1024, "
          f"{cfg['frames']} x {cfg['batch']}, bf16), forward + backward: "
          f"port {port_ms:.3f} ms host clock; cuDNN nn.LSTM {lib_ms:.3f} ms "
          f"host clock, {lib_dev:.3f} ms device ({port_ms / lib_ms:.1f}x; "
          f"cuDNN keeps c in fp32: a yardstick only) [{card}]")
    del model, params, state
    torch.cuda.empty_cache()
    return launches


# MLPerf Training's RetinaNet (mlcommons/training single_stage_detector:
# torchvision RetinaNet, ResNeXt50-32x4d FPN, 800 x 800, the 264 classes of
# the OpenImages MLPerf subset, 9 anchors a position, focal alpha 0.25,
# gamma 2): the classification head over P3-P7, batch 8, bf16, weights
# N(0, 0.01) and the prior bias -log(99), as torchvision initializes them
RETINA = dict(batch=8, levels=(100, 50, 25, 13, 7), channels=256, tower=4,
              anchors=9, classes=264, padded=272, alpha=0.25, gamma=2.0)
RETINA_TARGETS = (0.01, 0.05)     # shares positive, ignored (-2)
RETINA_RES2 = (200, 256, 128)     # side, channels in, bottleneck width
RETINA_ITERS = 3
# bf16 compute against fp32 from the same weights and features, 5 conv
# layers deep: the loss within 1e-3 relative (the first H100 run of this
# check read 2.3e-4). A grad leaf's error, by relative norm, grows a layer
# at a time from the loss down the tower: on each of three seeds the
# class conv's leaves read ~0.5% and the first tower layer's ~10%
# (PERF.md). It is not the logits' bf16 rounding at the prior
# bias -log 99 (a step of 2**-5 there): with the class conv's output kept
# in fp32 the tower's errors stay within ~8% of themselves. Each leaf is
# held to its layer's limit, 1.5x the worst reading of that layer over
# the seeds. The ops themselves are held against the CPU in fp32
# (retina_small_holds); this check bounds bf16's precision loss
RETINA_GRAD_SEEDS = (0, 1, 2)
TOL_RETINA_LOSS = 1e-3
TOL_RETINA_GRAD = {"cls": 8e-3, "tower.3": 6.5e-2, "tower.2": 0.10,
                   "tower.1": 0.13, "tower.0": 0.15}


def retina_params(torch, cfg: dict, device: str, classes: int,
                  seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    c = cfg["channels"]

    def normal(*shape):
        return (torch.randn(shape, generator=gen) * 0.01).to(
            device).requires_grad_(True)

    tower = [(normal(3, 3, c, c), torch.zeros(c, device=device,
                                              requires_grad=True))
             for _ in range(cfg["tower"])]
    cls_w = normal(3, 3, c, cfg["anchors"] * classes)
    cls_b = torch.full((cfg["anchors"] * classes,), -math.log(99.0),
                       device=device, requires_grad=True)
    return tower, cls_w, cls_b


def retina_inputs(torch, cfg: dict, device: str, levels=None, batch=None,
                  seed: int = 0):
    """P3-P7 features N(0, 1), NHWC, and per-anchor targets: a share
    positive (a class), a share ignored (-2), the rest all-negative (-1),
    from ``RandomState(seed)``."""
    import numpy as np
    rng = np.random.RandomState(seed)
    b = batch or cfg["batch"]
    levels = levels or cfg["levels"]
    feats = [torch.from_numpy(rng.randn(b, s, s, cfg["channels"]).astype(
        np.float32)).to(device) for s in levels]
    n = b * sum(s * s for s in levels) * cfg["anchors"]
    u = rng.rand(n)
    targets = np.full(n, -1, np.int64)
    pos = u < RETINA_TARGETS[0]
    targets[pos] = rng.randint(0, cfg["classes"], int(pos.sum()))
    targets[(u >= RETINA_TARGETS[0])
            & (u < RETINA_TARGETS[0] + RETINA_TARGETS[1])] = -2
    targets = torch.from_numpy(targets.reshape(b, -1)).to(device)
    return feats, targets, torch.tensor(float(max(pos.sum(), 1)),
                                        device=device)


def retina_head(torch, feats, tower, cls_w, cls_b, classes: int, dtype,
                cls_dtype=None):
    """The head's logits in ``dtype``; with ``cls_dtype``, the class conv
    takes the tower's output cast to it."""
    from apex_tpu_torch.ops import conv_bias, conv_bias_relu
    outs = []
    for x in feats:
        h = x.to(dtype)
        for w, b in tower:
            h = conv_bias_relu(h, w, b, padding=1)
        o = conv_bias(h.to(cls_dtype or dtype), cls_w, cls_b, padding=1)
        outs.append(o.reshape(o.shape[0], -1, classes))
    return torch.cat(outs, 1)


def retina_small_holds(torch, card: str) -> None:
    """Each op on the card against the CPU at batch 1 on P5, fp32."""
    import numpy as np
    from apex_tpu_torch import ops

    cfg = RETINA
    rng = np.random.RandomState(2)
    s, c = cfg["levels"][2], cfg["channels"]
    host = {"x": rng.randn(1, s, s, c), "w": rng.randn(3, 3, c, c) * 0.02,
            "b": rng.randn(c) * 0.1, "scale": 1 + 0.1 * rng.randn(c),
            "mask": (rng.rand(1, s, s, c) > 0.5) * 1.0,
            "logits": 3 * rng.randn(1, s * s * cfg["anchors"],
                                    cfg["classes"]),
            "targets": rng.randint(-2, cfg["classes"],
                                   (1, s * s * cfg["anchors"]))}
    runs = {}
    for dev in ("cuda", "cpu"):
        t = {k: torch.from_numpy(v.astype(np.int64 if k == "targets"
                                          else np.float32)).to(dev)
             for k, v in host.items()}
        logits = t["logits"].requires_grad_(True)
        loss = ops.focal_loss(logits, t["targets"], torch.tensor(
            50.0, device=dev), cfg["classes"], cfg["alpha"], cfg["gamma"])
        loss.backward()
        runs[dev] = {
            "conv_bias": ops.conv_bias(t["x"], t["w"], t["b"], padding=1),
            "conv_bias_relu": ops.conv_bias_relu(t["x"], t["w"], t["b"],
                                                 padding=1),
            "conv_bias_mask_relu": ops.conv_bias_mask_relu(
                t["x"], t["w"], t["b"], t["mask"], padding=1),
            "conv_frozen_scale_bias_relu": ops.conv_frozen_scale_bias_relu(
                t["x"], t["w"], t["scale"], t["b"], stride=2, padding=1),
            "focal_loss": loss.detach(), "focal_loss grad": logits.grad}
    errs = {k: float((runs["cuda"][k].cpu() - v).abs().max()
                     / v.abs().max().clamp(min=1e-30))
            for k, v in runs["cpu"].items()}
    worst = max(errs.values())
    check(worst <= TOL_CARD_CPU, f"retinanet_head: card vs CPU {errs} > "
                                 f"{TOL_CARD_CPU}")
    print(f"retinanet_head: card vs CPU (fp32, batch 1 on P5 {s} x {s} x "
          f"{c}), max |diff| / max |CPU|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (tol {TOL_CARD_CPU}) [{card}]")


def retina_tol(leaf: str) -> float:
    """The bf16-vs-fp32 grad limit of ``leaf``'s layer."""
    return TOL_RETINA_GRAD[leaf.rsplit(".", 1)[0]]


def retina_precision(torch, cfg: dict, seed: int, cls_dtype=None) -> tuple:
    """``(loss error, {leaf: grad error})`` of the head in bf16 (the class
    conv's output in ``cls_dtype`` if given) against fp32, from seed
    ``seed``'s weights and features: relative, the grads by norm."""
    from apex_tpu_torch import ops
    k = cfg["classes"]
    feats, targets, npos = retina_inputs(torch, cfg, "cuda", seed=seed)
    tower, cls_w, cls_b = retina_params(torch, cfg, "cuda", k, seed=seed)
    leaves = [t for pair in tower for t in pair] + [cls_w, cls_b]
    names = [f"tower.{i}.{kind}" for i in range(len(tower))
             for kind in ("weight", "bias")] + ["cls.weight", "cls.bias"]
    runs = []
    for dtype, cdt in ((torch.bfloat16, cls_dtype),
                       (torch.float32, None)):
        logits = retina_head(torch, feats, tower, cls_w, cls_b, k, dtype,
                             cdt)
        loss = ops.focal_loss(logits, targets, npos, k, cfg["alpha"],
                              cfg["gamma"])
        grads = torch.autograd.grad(loss, leaves)
        runs.append((float(loss.detach()), grads))
        del logits, loss
    (loss, grads), (loss32, grads32) = runs
    check(math.isfinite(loss), f"retinanet_head: seed {seed} loss {loss}")
    errs = {n: float((g - r).norm() / r.norm())
            for n, g, r in zip(names, grads, grads32)}
    del runs, grads, grads32, feats, targets
    torch.cuda.empty_cache()
    return abs(loss - loss32) / abs(loss32), errs


def retinanet_head(torch, kern, card: str) -> dict:
    """MLPerf RetinaNet's classification head (``RETINA``) at batch 8,
    bf16, channels-last: the tower of 4 ``conv_bias_relu`` and the
    ``conv_bias`` to 9 x 264 over P3-P7, then ``focal_loss``; forward +
    backward ms, focal loss's own, launches, busy share, peak memory; the
    loss and grads against an fp32 run on the card on each of
    ``RETINA_GRAD_SEEDS``, and on seed 0 with the class conv's output
    kept in fp32 (printed, to show where the error arises); ``focal_loss``
    again on the class axis padded to 272 (``num_real_classes`` 264), equal to
    the unpadded call; ``conv_frozen_scale_bias_relu`` at a frozen-BN
    ResNeXt res2 block's 1x1 and 3x3 (dense: the ops take no groups) and
    ``conv_bias_mask_relu`` at P3 with a 0/1 mask, timed; the small holds
    against the CPU. Returns the port-kernel launches (none: cuDNN and
    torch ops, as the reference leaves them to XLA)."""
    from apex_tpu_torch import ops

    cfg = RETINA
    retina_small_holds(torch, card)
    k = cfg["classes"]
    feats, targets, npos = retina_inputs(torch, cfg, "cuda")
    tower, cls_w, cls_b = retina_params(torch, cfg, "cuda", k)
    leaves = [t for pair in tower for t in pair] + [cls_w, cls_b]
    anchors = targets.shape[1]

    def loss_of(dtype):
        logits = retina_head(torch, feats, tower, cls_w, cls_b, k, dtype)
        return ops.focal_loss(logits, targets, npos, k, cfg["alpha"],
                              cfg["gamma"])

    def fwd_bwd():
        for t in leaves:
            t.grad = None
        loss = loss_of(torch.bfloat16)
        loss.backward()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kern.reset_launches()
    loss = fwd_bwd()
    torch.cuda.synchronize()
    launches = dict(kern.LAUNCHES)
    head_ms = 1e3 * _host_time(torch, fwd_bwd, RETINA_ITERS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(math.isfinite(float(loss)), f"retinanet_head: loss {float(loss)}")
    check(sum(launches.values()) == 0, f"retinanet_head launched the port's "
                                       f"kernels {launches}")
    print(f"retinanet_head: batch {cfg['batch']}, P3-P7 {cfg['levels']}, "
          f"{anchors} anchors x {k} classes ({cfg['batch'] * anchors * k} "
          f"logits, {int(float(npos))} positive), bf16: loss "
          f"{float(loss):.6f}, forward + backward {head_ms:.3f} ms (host "
          f"clock, synchronized), peak memory {peak:.3f} GiB [{card}]")
    profile_step(torch, "retinanet head forward + backward", fwd_bwd, card,
                 iters=1, top=8)

    # bf16 against fp32 from the same weights and features, on each seed
    errs = {}
    for seed in RETINA_GRAD_SEEDS:
        l_err, errs[seed] = retina_precision(torch, cfg, seed)
        check(l_err <= TOL_RETINA_LOSS, f"retinanet_head: seed {seed}, bf16 "
                                        f"loss vs fp32 {l_err:.3g} > "
                                        f"{TOL_RETINA_LOSS}")
        print(f"retinanet_head: seed {seed}, bf16 vs fp32 on the card: "
              f"loss relative {l_err:.4g} (tol {TOL_RETINA_LOSS}); grads by "
              "leaf: " + ", ".join(f"{n} {v:.4g} (tol {retina_tol(n)})"
                                   for n, v in errs[seed].items()))
        over = {n: v for n, v in errs[seed].items() if v > retina_tol(n)}
        check(not over, f"retinanet_head: seed {seed}, bf16 grads vs fp32 "
                        f"over their layer's limit {over}")
    _, kept = retina_precision(torch, cfg, 0, cls_dtype=torch.float32)
    print("retinanet_head: seed 0, the class conv's output kept in fp32, "
          "grads by leaf against fp32: " + ", ".join(
              f"{n} {v:.4g} ({v / errs[0][n]:.3f} x bf16's)"
              for n, v in kept.items() if errs[0][n] > 0) + f" [{card}]")
    for t in leaves:
        t.grad = None

    # focal loss alone, then with the class axis padded
    with torch.no_grad():
        logits = retina_head(torch, feats, tower, cls_w, cls_b, k,
                             torch.bfloat16)
    logits.requires_grad_(True)

    def focal():
        logits.grad = None
        out = ops.focal_loss(logits, targets, npos, k, cfg["alpha"],
                             cfg["gamma"])
        out.backward()
        return out

    focal_ms = 1e3 * _host_time(torch, focal, RETINA_ITERS)
    focal_dev = device_ms(torch, focal, iters=2)
    plain = focal().detach()
    g_plain = logits.grad.clone()
    junk = 10 * torch.randn(*logits.shape[:-1], cfg["padded"] - k,
                            device="cuda", dtype=logits.dtype)
    padded = torch.cat([logits.detach(), junk], -1).requires_grad_(True)
    loss_pad = ops.focal_loss(padded, targets, npos, k, cfg["alpha"],
                              cfg["gamma"])
    loss_pad.backward()
    loss_pad = loss_pad.detach()
    p_err = abs(float(loss_pad) - float(plain)) / abs(float(plain))
    check(p_err <= TOL_CARD_CPU and bool((padded.grad[..., k:] == 0).all())
          and torch.equal(padded.grad[..., :k], g_plain),
          f"retinanet_head: the padded call {float(loss_pad)} against "
          f"{float(plain)}, or its grads differ")
    print(f"retinanet_head: focal_loss (bf16 logits, fp32 math) forward + "
          f"backward {focal_ms:.3f} ms host clock, {focal_dev:.3f} ms device;"
          f" padded to {cfg['padded']} classes, num_real_classes {k}: loss "
          f"{float(loss_pad):.6f}, relative {p_err:.3g} to the unpadded "
          f"call, the padding's grads 0, the rest equal bit for bit "
          f"[{card}]")
    del logits, padded, junk, g_plain
    torch.cuda.empty_cache()

    # a frozen-BN ResNeXt res2 block's convs and the masked conv at P3
    side, cin, width = RETINA_RES2
    gen = torch.Generator().manual_seed(4)
    b = cfg["batch"]

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(
            "cuda", torch.bfloat16)

    x = rand(b, side, side, cin).requires_grad_(True)
    w1 = rand(1, 1, cin, width, scale=cin ** -0.5).float().requires_grad_()
    w2 = rand(3, 3, width, width, scale=(9 * width) ** -0.5).float(
        ).requires_grad_()
    s1, b1 = torch.ones(width, device="cuda"), torch.zeros(width,
                                                           device="cuda")

    def res2():
        h = ops.conv_frozen_scale_bias_relu(x, w1, s1, b1)
        h = ops.conv_frozen_scale_bias_relu(h, w2, s1, b1, padding=1)
        h.float().sum().backward()

    p3 = cfg["levels"][0]
    xm = rand(b, p3, p3, cfg["channels"]).requires_grad_(True)
    wm = rand(3, 3, cfg["channels"], cfg["channels"], scale=0.02).float(
        ).requires_grad_()
    bm = torch.zeros(cfg["channels"], device="cuda", requires_grad=True)
    mask = (torch.rand(b, p3, p3, cfg["channels"], generator=torch.Generator(
        device="cuda").manual_seed(5), device="cuda") > 0.5).to(
        torch.bfloat16)

    def masked():
        ops.conv_bias_mask_relu(xm, wm, bm, mask, padding=1).float().sum(
            ).backward()

    res2_ms, masked_ms = (device_ms(torch, fn, iters=3)
                          for fn in (res2, masked))
    print(f"retinanet_head: conv_frozen_scale_bias_relu 1x1 {cin} -> {width}"
          f" then 3x3 {width} -> {width} at {b} x {side} x {side}, forward +"
          f" backward {res2_ms:.3f} ms device; conv_bias_mask_relu 3x3 at P3"
          f" {b} x {p3} x {p3} x {cfg['channels']} with a 0/1 mask "
          f"{masked_ms:.3f} ms device [{card}]")
    del feats, tower, cls_w, cls_b, leaves, x, xm, mask
    torch.cuda.empty_cache()
    return launches


ASP_STEPS = 3              # masked steps; then one forced to overflow
ASP_UNMASKED_STEPS = 3     # the same step without ASP, in the same run
ASP_PERMUTE_PASSES = 1     # greedy passes of the fc1 permutation search


def asp_gpt(torch, kern, card: str) -> dict:
    """GPT-small under ASP at ``_gpt_train_step``'s shape (8 x 1024,
    ``FusedAdam``, ``DynamicLossScale``; B1-B3, B7, B8): the 2:4 masks
    computed on the card, bit for bit those computed on the CPU from the
    same weights; pruned, ``FusedAdam`` wrapped by
    ``init_optimizer_for_pruning``, ``ASP_STEPS`` steps, then one forced to
    overflow (an infinite loss scale): after each, every pruned
    entry exactly 0 and every whitelisted group of 4 at most 2 nonzeros,
    the overflow step's params unchanged. Step ms and launches beside the
    unmasked step's; ``permute=True`` on one layer's ``fc1`` weight (the
    retained magnitude at least the identity's, the search's host
    seconds). Returns the launches of the masked steps."""
    import numpy as np
    from apex_tpu_torch.contrib.sparsity import ASP
    from apex_tpu_torch.contrib.sparsity.permutation import (
        search_channel_permutation)
    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(**GPT_SMALL)
    batch, seq = TRAIN_BH[0], TRAIN_ATTN[1]
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    init = GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    del init
    asp = ASP()
    t0 = time.perf_counter()
    masks = asp.compute_sparse_masks(init_state)
    torch.cuda.synchronize()
    mask_ms = 1e3 * (time.perf_counter() - t0)
    cpu_masks = asp.compute_sparse_masks({k: v.cpu() for k, v in
                                          init_state.items()})
    same = all(torch.equal(masks[n].cpu(), cpu_masks[n]) for n in masks)
    pruned_names = [n for n, m in masks.items() if not bool(m.all())]
    check(same, "asp_gpt: masks on the card differ from the CPU's")
    check(len(pruned_names) == 4 * cfg.num_layers,
          f"asp_gpt: {len(pruned_names)} leaves pruned, not "
          f"{4 * cfg.num_layers}")
    print(f"asp_gpt: 2:4 masks of {len(pruned_names)} leaves (qkv, proj, fc1,"
          f" fc2 of each layer) in {mask_ms:.3f} ms on the card, bit for bit"
          f" those computed on the CPU [{card}]")
    asp.prune(init_state, masks)
    off = {n: ~masks[n] for n in pruned_names}

    def sparse_ok(params) -> bool:
        ok = True
        for n in pruned_names:
            p = params[n].detach()
            ok &= bool((p[off[n]] == 0).all())
            ok &= bool(((p.reshape(-1, 4) != 0).sum(-1) <= 2).all())
        return ok

    def run(step, n_steps: int, what: str):
        launches = {name: 0 for name in kern.LAUNCHES}
        times = []
        for i in range(n_steps):
            torch.cuda.synchronize()
            kern.reset_launches()
            t0 = time.perf_counter()
            loss, finite, grads = step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            del grads
            check(bool(finite) and bool(torch.isfinite(loss)),
                  f"asp_gpt: {what} step {i} loss {float(loss)} not finite")
            for name, n in kern.LAUNCHES.items():
                launches[name] += n
        return launches, times

    masked = gpt_trainer(torch, cfg, init_state, tokens, 1e-4,
                         opt_wrap=lambda opt: asp.init_optimizer_for_pruning(
                             opt, masks))
    check(sparse_ok(masked.params), "asp_gpt: the pruned model is not 2:4")
    launches, times = run(masked, ASP_STEPS, "masked")
    check(sparse_ok(masked.params), "asp_gpt: a masked step left a pruned "
                                    "entry nonzero or a group past 2 of 4")
    before = {n: p.detach().clone() for n, p in masked.params.items()}
    carry = masked.carry
    carry["ls"] = carry["ls"]._replace(
        loss_scale=torch.full_like(carry["ls"].loss_scale, math.inf))
    kern.reset_launches()
    _, finite, _ = masked()
    for name, n in kern.LAUNCHES.items():
        launches[name] += n
    unchanged = all(torch.equal(before[n], p) for n, p in
                    masked.params.items())
    check(not bool(finite) and unchanged and sparse_ok(masked.params),
          "asp_gpt: the overflow step was not skipped, or broke the 2:4 "
          "pattern")
    del before
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(launches[name] == (ASP_STEPS + 1) * cfg.num_layers,
              f"asp_gpt: {name} launched {launches[name]} times")
    masked_ms = 1e3 * min(times[1:])
    del masked
    torch.cuda.empty_cache()
    plain = gpt_trainer(torch, cfg, init_state, tokens, 1e-4)
    plain_launches, plain_times = run(plain, ASP_UNMASKED_STEPS, "unmasked")
    del plain
    torch.cuda.empty_cache()
    plain_ms = 1e3 * min(plain_times[1:])
    print(f"asp_gpt: {ASP_STEPS} masked steps and one overflow step (skipped,"
          f" params unchanged), every pruned entry 0 and every group of 4 at"
          f" most 2 nonzeros after each; step {masked_ms:.3f} ms against "
          f"{plain_ms:.3f} ms unmasked (the best of steps 1-"
          f"{ASP_STEPS - 1}, host clock); launches masked {launches}, "
          f"unmasked {plain_launches} [{card}]")

    name = "layers.0.fc1.weight"
    w = init_state[name]
    t0 = time.perf_counter()
    perm, eff_id, eff_perm = search_channel_permutation(
        w, method="greedy", max_passes=ASP_PERMUTE_PASSES)
    search_s = time.perf_counter() - t0
    check(eff_perm >= eff_id and sorted(perm.tolist()) == list(range(
        w.shape[-1])), f"asp_gpt: the permutation lost magnitude "
                       f"{eff_perm} < {eff_id}")
    print(f"asp_gpt: permute=True on {name} {tuple(w.shape)} (greedy, "
          f"{ASP_PERMUTE_PASSES} pass, 512 rows sampled): retained "
          f"magnitude {eff_perm:.4f} against the identity's {eff_id:.4f} "
          f"(x{eff_perm / eff_id:.5f}), {search_s:.2f} s of host numpy")
    del init_state, masks, cpu_masks
    torch.cuda.empty_cache()
    return launches


TP1_DROPOUT = 0.1
TOL_TP1_XENT = 1e-5     # fp32 math on the same bf16 logits, other sums


def tp1_gpt(torch, kern, card: str) -> dict:
    """The tp=1 pieces on GPT-small: ``model_parallel_seed(1234)`` on the
    card, one GPT-small layer (8 x 1024, bf16, hidden and attention
    dropout 0.1) with its masks drawn from ``get_rng_tracker().fork()``:
    wrapped in ``checkpoint``, the loss and every grad bit for bit those of
    the unwrapped layer from the same generator state, and a second fork
    new masks; then ``vocab_parallel_cross_entropy`` on GPT-small's logits
    (8 x 1024 x 32768, bf16) against ``softmax_cross_entropy_loss`` at
    smoothing 0 (loss and grads) and against the reference's smoothing
    formula at 0.1, fp32 on the card. Returns the launches of the layer
    runs and the logits' forward."""
    import numpy as np
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.ops import softmax_cross_entropy_loss
    from apex_tpu_torch.transformer import tensor_parallel as tp

    cfg = dataclasses.replace(GPTConfig(**GPT_SMALL),
                              hidden_dropout=TP1_DROPOUT,
                              attention_dropout=TP1_DROPOUT)
    model = GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    lp = model.layers[0]
    batch, seq = TRAIN_BH[0], TRAIN_ATTN[1]
    x = torch.randn(batch, seq, cfg.hidden_size, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(1)
                    ).to(torch.bfloat16)

    def layer(h, gen):
        seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=gen,
                                 device=gen.device))
        return model._layer(lp, h, seed, gen)

    def run(fn):
        xx = x.clone().requires_grad_(True)
        with tracker.fork() as gen:
            out = fn(xx, gen)
            loss = (out.float() ** 2).mean()
            loss.backward()
        grads = [xx.grad] + [p.grad.clone() for p in lp.parameters()]
        for p in lp.parameters():
            p.grad = None
        return loss.detach(), grads

    tp.model_parallel_seed(1234, device="cuda")
    tracker = tp.get_rng_tracker()
    states = tracker.get_states()
    launches = {name: 0 for name in kern.LAUNCHES}
    legs = {}
    for what, fn in (("plain", layer), ("checkpoint", tp.checkpoint(layer))):
        tracker.set_states(states)
        kern.reset_launches()
        legs[what] = run(fn)
        torch.cuda.synchronize()
        legs[what] += (dict(kern.LAUNCHES),)
        for name, n in kern.LAUNCHES.items():
            launches[name] += n
    (l0, g0, c0), (l1, g1, c1) = legs["plain"], legs["checkpoint"]
    same = torch.equal(l0, l1) and all(torch.equal(a, b)
                                       for a, b in zip(g0, g1))
    check(same, "tp1_gpt: checkpoint's loss or grads differ from the "
                "unwrapped layer's")
    check(c1["flash_fwd"] == 2 * c0["flash_fwd"] == 2 and
          c1["ln_fwd"] == 2 * c0["ln_fwd"] == 4,
          f"tp1_gpt: checkpoint did not recompute the layer ({c0}, {c1})")
    kern.reset_launches()
    l2, _ = run(tp.checkpoint(layer))
    for name, n in kern.LAUNCHES.items():
        launches[name] += n
    check(not torch.equal(l2, l0), "tp1_gpt: a second fork gave the same "
                                   "masks")
    print(f"tp1_gpt: one GPT-small layer ({batch} x {seq}, bf16, dropout "
          f"{TP1_DROPOUT} from get_rng_tracker().fork()): loss "
          f"{float(l0):.6f}, under checkpoint {float(l1):.6f}, every grad "
          f"bit for bit; launches {c0} and {c1}; a second fork {float(l2):.6f}"
          f" [{card}]")
    del legs, g0, g1

    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    with torch.no_grad():
        kern.reset_launches()
        logits = model(tokens).to(torch.bfloat16)
        for name, n in kern.LAUNCHES.items():
            launches[name] += n
    del model
    results = {}
    for what in ("vocab_parallel", "xentropy"):
        # fp32 copies of the bf16 logits, so the grads are not rounded
        lg = logits.float().requires_grad_(True)
        if what == "vocab_parallel":
            loss = tp.vocab_parallel_cross_entropy(lg, tokens)
        else:
            loss = softmax_cross_entropy_loss(
                lg.reshape(-1, cfg.vocab_size), tokens.reshape(-1),
                padding_idx=None, half_to_float=True).reshape(tokens.shape)
        loss.sum().backward()
        results[what] = (loss.detach(), lg.grad)
        del lg
    (lv, gv), (lx, gx) = results["vocab_parallel"], results["xentropy"]
    l_err = float((lv - lx).abs().max() / lx.abs().max())
    g_err = float((gv - gx).abs().max() / gx.abs().max())
    del results, gv, gx
    lf = logits.float()
    with torch.no_grad():
        ls = tp.vocab_parallel_cross_entropy(logits, tokens, 0.1)
        lse = torch.logsumexp(lf, -1)
        nll = lse - torch.gather(lf, -1, tokens[..., None])[..., 0]
        want = 0.9 * nll + 0.1 * (lse - lf.mean(-1))
    s_err = float((ls - want).abs().max() / want.abs().max())
    del lf, logits
    torch.cuda.empty_cache()
    check(max(l_err, g_err, s_err) <= TOL_TP1_XENT,
          f"tp1_gpt: vocab-parallel cross-entropy loss {l_err:.3g}, grads "
          f"{g_err:.3g}, smoothed {s_err:.3g} > {TOL_TP1_XENT}")
    print(f"tp1_gpt: vocab_parallel_cross_entropy on GPT-small's logits "
          f"({batch} x {seq} x {cfg.vocab_size}, bf16) against "
          f"softmax_cross_entropy_loss: loss {l_err:.3g}, grads {g_err:.3g};"
          f" smoothing 0.1 against (1 - s) nll + s (lse - mean) in fp32: "
          f"{s_err:.3g} (tol {TOL_TP1_XENT}, of the largest magnitude) "
          f"[{card}]")
    return launches


# -- data parallelism: NCCL at world 1 in this process, then two ranks ------
DDP_STEPS = 4              # a warm step, then the timed ones
DDP_MICRO = 2              # accumulate_gradients' window of 2 x 4 x 1024
ZERO_STEPS = 5
ZERO_BUCKET_BYTES = 4 << 20
# ZeRO at world 1 against FusedAdam: the same fp32 arithmetic element for
# element (the reduce-scatter and all-gather of one rank are copies and
# the 1 / dp scale is 1.0), so the losses should agree bit for bit; the
# limit allows one fp32 ulp of a ~10.4 loss (9.5e-7) a step over 5 steps,
# for a vectorized kernel that rounded an update otherwise
TOL_ZERO_LOSS = 5e-6
# ZeRO at world 2: a rank's Adam moments after step 0 against the first
# moments of the DDP-averaged grads (a plain all-reduce of the whole flat
# grads, this rank's bucket slices), relative norm. Two ranks' sum is the
# same in either order and the 1/2, the unscale and Adam's first step are
# the same fp32 products, so the reading should be 0; the limit allows an
# ulp a term. A missing or doubled 1 / dp moves m by 1.0 or 0.5, a shard
# stepped on its own rank's grads by the grads' spread across ranks
TOL_ZERO_MOMENTS = 1e-6
DIST_WORLD = 2
# zero_gpt, dist_ranks' DDP and ZeRO ranks and ep_spatial's ZeRO ranks run
# GPT-small's widths at this depth (gloo stages every reduction through
# the host; the checks are the same at any depth)
DIST_LAYERS = 2
DIST_TIMEOUT = 600.0       # seconds a call of the two ranks may take
# this torch's gloo takes CUDA tensors in all_reduce (sum, min, max),
# reduce_scatter_tensor and all_gather_into_tensor, async too (probed on
# torch 2.11.0+cu128 on the H100), so every two-rank check runs over gloo
# on the card; two ranks on one card cannot share NCCL (ncclInvalidUsage)
GLOO_CUDA_OPS = ("all_reduce", "reduce_scatter_tensor",
                 "all_gather_into_tensor")
# one rank's batch of ResNet-50's first bottleneck BN (NCHW, fp32), the
# whole batch then 2 x 128; and an uneven split of the same 256 images
SYNCBN_SHAPE = (128, 64, 56, 56)
SYNCBN_UNEVEN = (96, 160)
# synced BN against the whole batch on one rank, fp32, of each tensor's
# largest magnitude: the statistics summed in other orders (two partial
# sums and an all-reduce against one reduction), 802816 values a channel
TOL_SYNCBN = 1e-5


def gpt_small_setup(torch, layers: int = None):
    """GPT-small's config (at ``layers`` layers of its widths when given:
    the multi-process legs' cut depth), ``train``'s init state (seed 0)
    and tokens (8 x 1024 from ``RandomState(0)``)."""
    import numpy as np
    from apex_tpu_torch.models import GPTConfig, GPTModel

    cfg = GPTConfig(**gpt_small_at(layers))
    batch, seq = TRAIN_BH[0], TRAIN_ATTN[1]
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, seq))).to("cuda")
    init = GPTModel(cfg, device="cuda").init(torch.Generator().manual_seed(0))
    init_state = {k: v.detach().clone() for k, v in init.state_dict().items()}
    return cfg, init_state, tokens


def gpt_small_at(layers: int = None) -> dict:
    """GPT-small's widths at ``layers`` layers (all 12 when None)."""
    return dict(GPT_SMALL, num_layers=layers or GPT_SMALL["num_layers"])


def check_gpt_counts(counts: dict, what: str, passes: int = 1,
                     layers: int = None) -> None:
    """A GPT-small training step's launches: 12 of each flash kernel and
    25 of each LayerNorm kernel a forward and backward (``layers`` and
    ``2 * layers + 1`` at a cut depth)."""
    L = layers or GPT_SMALL["num_layers"]
    ln = LN_PER_GPT_PASS if layers is None else 2 * layers + 1
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        check(counts[name] == passes * L,
              f"{what}: {name} launched {counts[name]} times, not "
              f"{passes * L}")
    for name in ("ln_fwd", "ln_bwd"):
        check(counts[name] == passes * ln,
              f"{what}: {name} launched {counts[name]} times, not "
              f"{passes * ln}")


def add_counts(total: dict, counts: dict) -> None:
    for name, n in counts.items():
        total[name] = total.get(name, 0) + n




def timed_steps(torch, kern, step, n: int, what: str, launches=None,
                passes: int = 1, layers: int = None) -> tuple:
    """``n`` synchronized steps: their losses, host-clock seconds and the
    first step's unscaled grads; each step's launches checked and added
    into ``launches``."""
    losses, times, grads0 = [], [], None
    for i in range(n):
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        loss, finite, grads = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(kern.LAUNCHES)
        check_gpt_counts(counts, f"{what} step {i}", passes, layers)
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"{what} step {i}: loss {float(loss)} or grads not finite")
        if launches is not None:
            add_counts(launches, counts)
        losses.append(loss)
        if i == 0:
            grads0 = grads
        del grads
    return losses, times, grads0


def median_ms(times) -> float:
    later = sorted(times[1:])
    return 1e3 * later[len(later) // 2]


def ddp_gpt(torch, kern, card: str) -> dict:
    """GPT-small's training step (``train``'s: 8 x 1024, FusedAdam,
    ``DynamicLossScale``) with its grads synced by
    ``DistributedDataParallel(bucket_bytes=DEFAULT_BUCKET_BYTES)`` over
    NCCL at world 1, against the same step unsynced, in turns: losses and
    step 0's grads bit for bit (one rank's all-reduce is a copy, the
    average a multiply by 1.0), step ms, buckets and bytes reduced a step
    (the ``ddp/*`` metrics) and the NCCL kernels' launches and device ms
    in a profile of the synced step. Then ``accumulate_gradients`` over
    two microbatches of 4 x 1024 against the same window by hand, unsynced:
    the loss and grads bit for bit. Returns the synced runs' launches."""
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.observability import ingraph
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.distributed import DEFAULT_BUCKET_BYTES
    from apex_tpu_torch.training import accumulate_gradients

    cfg, init_state, tokens = gpt_small_setup(torch)
    ddp = DistributedDataParallel(bucket_bytes=DEFAULT_BUCKET_BYTES)
    launches = {name: 0 for name in kern.LAUNCHES}
    legs = {}
    for what, sync in (("plain", None), ("ddp", ddp.sync_gradients)):
        step = gpt_trainer(torch, cfg, init_state, tokens, 1e-4,
                           grad_sync=sync)
        with ingraph.collecting() as col:
            legs[what] = timed_steps(torch, kern, step, DDP_STEPS,
                                     f"ddp_gpt {what}",
                                     launches if sync else None)
            metrics = col.freeze().as_floats()
        if sync is not None:
            kern.reset_launches()
            rows, wall_ms, _ = profile_window(torch, step, 2,
                                              "profile ddp_gpt step")
            add_counts(launches, kern.LAUNCHES)
            ddp_metrics = metrics
        del step
        torch.cuda.empty_cache()
    (l_p, t_p, g_p), (l_d, t_d, g_d) = legs["plain"], legs["ddp"]
    same_losses = all(torch.equal(a, b) for a, b in zip(l_p, l_d))
    same_grads = all(torch.equal(g_p[n], g_d[n]) for n in g_p)
    check(same_losses and same_grads,
          f"ddp_gpt: at world 1 the synced step's losses "
          f"{[float(x) for x in l_d]} or step 0's grads differ from the "
          f"unsynced step's {[float(x) for x in l_p]}")
    nccl = [r for r in rows if "nccl" in r[0].lower()]
    busy = sum(r[1] for r in rows)
    print(f"ddp_gpt: GPT-small ({TRAIN_BH[0]} x {TRAIN_ATTN[1]}) synced by "
          f"DistributedDataParallel(bucket_bytes={DEFAULT_BUCKET_BYTES}) "
          f"over NCCL at world 1: {DDP_STEPS} losses and step 0's grads "
          f"bit for bit the unsynced step's; median step "
          f"{median_ms(t_d):.3f} ms against {median_ms(t_p):.3f} unsynced "
          f"(host clock, in turns), "
          f"{ddp_metrics['ddp/num_buckets']:.0f} buckets of "
          f"{ddp_metrics['ddp/bucket_bytes']:.0f} bytes, "
          f"{ddp_metrics['ddp/allreduce_bytes'] / DDP_STEPS:.0f} bytes "
          f"reduced a step [{card}]")
    print(f"ddp_gpt: profile of the synced step: wall {wall_ms:.3f} ms, "
          f"device busy {busy:.3f} ms; NCCL kernels "
          + (", ".join(f"{k[:60]} x{c:.0f} {ms:.4f} ms" for k, ms, c in nccl)
             or "none (one rank's all-reduce launches no kernel)")
          + f" [{card}]")
    del legs, g_p, g_d
    torch.cuda.empty_cache()

    model = GPTModel(cfg, device="cuda")
    model.load_state_dict(init_state)
    params = dict(model.named_parameters())
    leaves = list(params.values())
    window = tokens.reshape(DDP_MICRO, -1, tokens.shape[1])

    def loss_fn(p, mb):
        return model.loss(mb, mb)

    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    loss_a, grads_a = accumulate_gradients(
        DistributedDataParallel(delay_allreduce=True,
                                bucket_bytes=DEFAULT_BUCKET_BYTES),
        loss_fn, params, window)
    torch.cuda.synchronize()
    acc_ms = 1e3 * (time.perf_counter() - t0)
    check_gpt_counts(kern.LAUNCHES, "ddp_gpt accumulate_gradients",
                     DDP_MICRO)
    add_counts(launches, kern.LAUNCHES)
    acc = [torch.zeros_like(p) for p in leaves]
    loss_sum = None
    for k in range(DDP_MICRO):
        loss = loss_fn(params, window[k])
        acc = [a + g for a, g in zip(acc, torch.autograd.grad(loss, leaves))]
        loss = loss.detach()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    same = torch.equal(loss_a, loss_sum / DDP_MICRO) and all(
        torch.equal(grads_a[n], a / DDP_MICRO) for n, a in zip(params, acc))
    check(same, "ddp_gpt: accumulate_gradients at world 1 differs from "
                "the unsynced window")
    print(f"ddp_gpt: accumulate_gradients over {DDP_MICRO} microbatches of "
          f"{window.shape[1]} x {window.shape[2]}: loss "
          f"{float(loss_a):.6f} and grads bit for bit the unsynced window's;"
          f" {acc_ms:.3f} ms (host clock, first call) [{card}]")
    del model, params, leaves, grads_a, acc
    torch.cuda.empty_cache()
    return launches


def state_bytes(torch, state) -> int:
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(state)
               if isinstance(t, torch.Tensor))


def zero_config():
    """The ZeRO-1 config: adam (no weight decay, so the L2 and decoupled
    modes agree with ``train``'s FusedAdam) at lr 1e-4, 4 MiB buckets."""
    from apex_tpu_torch.config import OptimizerConfig, TrainConfig
    return TrainConfig(optimizer=OptimizerConfig(
        name="adam", lr=1e-4, weight_decay=0.0, zero=1),
        ddp_bucket_bytes=ZERO_BUCKET_BYTES)


def zero_gpt(torch, kern, card: str) -> tuple:
    """GPT-small's training step with the ZeRO-1 Adam that
    ``TrainConfig(zero=1, ddp_bucket_bytes=4 MiB)`` builds, over NCCL at
    world 1, against ``FusedAdam`` in turns: 5 losses within
    ``TOL_ZERO_LOSS``, step ms, optimizer-state bytes a rank, the
    ``zero/*`` metrics. Returns the ZeRO run's launches, its losses, its
    state bytes and the parameters' element count."""
    from apex_tpu_torch.observability import ingraph
    from apex_tpu_torch.optimizers import DistributedFusedAdam

    cfg, init_state, tokens = gpt_small_setup(torch, DIST_LAYERS)
    zopt = zero_config().build_optimizer()
    check(isinstance(zopt, DistributedFusedAdam)
          and zopt.bucket_bytes == ZERO_BUCKET_BYTES,
          f"zero_gpt: TrainConfig(zero=1) built {zopt!r}")
    launches = {name: 0 for name in kern.LAUNCHES}
    legs = {}
    for what, opt in (("fused_adam", None), ("zero", zopt)):
        step = gpt_trainer(torch, cfg, init_state, tokens, 1e-4,
                           optimizer=opt)
        with ingraph.collecting() as col:
            losses, times, _ = timed_steps(torch, kern, step, ZERO_STEPS,
                                           f"zero_gpt {what}",
                                           launches if opt else None,
                                           layers=DIST_LAYERS)
            metrics = col.freeze().as_floats()
        legs[what] = ([float(x) for x in losses], times,
                      state_bytes(torch, step.opt_state), metrics)
        del step
        torch.cuda.empty_cache()
    (l_a, t_a, b_a, _), (l_z, t_z, b_z, m_z) = legs["fused_adam"], \
        legs["zero"]
    err = max(abs(a - z) for a, z in zip(l_a, l_z))
    check(err <= TOL_ZERO_LOSS, f"zero_gpt: ZeRO losses {l_z} against "
                                f"FusedAdam's {l_a}: {err:.3g} > "
                                f"{TOL_ZERO_LOSS}")
    print(f"zero_gpt: GPT-small's widths at {DIST_LAYERS} layers with "
          f"TrainConfig(zero=1, ddp_bucket_bytes="
          f"{ZERO_BUCKET_BYTES}) over NCCL at world 1: losses {l_z}, "
          f"FusedAdam's {l_a}, max |diff| {err:.3g} (tol {TOL_ZERO_LOSS}"
          f"{', bit for bit' if err == 0 else ''}); median step "
          f"{median_ms(t_z):.3f} ms against {median_ms(t_a):.3f} (host "
          f"clock, in turns); optimizer state {b_z} bytes a rank (fp32 "
          f"master, m, v; zero/shard_bytes {m_z['zero/shard_bytes']:.0f}, "
          f"{m_z['ddp/num_buckets']:.0f} buckets) against FusedAdam's "
          f"{b_a} (m, v) [{card}]")
    return launches, l_z, b_z, zopt._layout.total


def _rank_setup(tp: int = 1, pp: int = 1, cp: int = 1):
    """A rank body's start: the kernels the parent built, the mesh (``tp``
    ranks a tensor group, ``pp`` a pipeline group, ``cp`` a context
    group), the parent's precision settings."""
    import torch
    from apex_tpu_torch import _kernels as kern
    from apex_tpu_torch.transformer import parallel_state as ps

    kern.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if (not ps.model_parallel_is_initialized()
            or ps.get_tensor_model_parallel_world_size() != tp
            or ps.get_pipeline_model_parallel_world_size() != pp
            or ps.get_context_parallel_world_size() != cp):
        ps.destroy_model_parallel()
        ps.initialize_model_parallel(tp, pp, context_parallel_size=cp)
    return torch, kern


def _grads_digest(grads: dict) -> str:
    h = hashlib.sha256()
    for g in grads.values():
        h.update(g.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def rank_ddp() -> dict:
    """A rank's DDP step on its half of GPT-small's batch (4 x 1024),
    synced over gloo on the card; rank 0 also takes the world-1 step on
    the whole batch and compares its grads with the synced ones."""
    torch, kern = _rank_setup()
    import torch.distributed as dist
    from apex_tpu_torch.parallel import DistributedDataParallel
    from apex_tpu_torch.parallel.distributed import DEFAULT_BUCKET_BYTES

    rank, world = dist.get_rank(), dist.get_world_size()
    cfg, init_state, tokens = gpt_small_setup(torch, DIST_LAYERS)
    rows = tokens.shape[0] // world
    ddp = DistributedDataParallel(bucket_bytes=DEFAULT_BUCKET_BYTES)
    step = gpt_trainer(torch, cfg, init_state,
                       tokens[rank * rows:(rank + 1) * rows], 1e-4,
                       grad_sync=ddp.sync_gradients)
    launches = {}
    losses, times, grads = timed_steps(torch, kern, step, 2,
                                       f"rank {rank} ddp", launches,
                                       layers=DIST_LAYERS)
    out = {"losses": [float(x) for x in losses], "launches": launches,
           "ms": 1e3 * times[1], "digest": _grads_digest(grads)}
    raw = {n: torch.randn_like(p) for n, p in step.params.items()}
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ddp.sync_gradients(raw)
        torch.cuda.synchronize()
    out["sync_ms"] = 1e3 * (time.perf_counter() - t0)
    del step, raw
    torch.cuda.empty_cache()
    if rank == 0:
        full = gpt_trainer(torch, cfg, init_state, tokens, 1e-4)
        kern.reset_launches()
        loss, _, want = full()
        torch.cuda.synchronize()
        add_counts(launches, kern.LAUNCHES)
        out["full_loss"] = float(loss)
        out["grad_err"] = grad_rel(torch, grads, want)
        del full, want
    del grads
    torch.cuda.empty_cache()
    return out


def zero_moments_err(torch, zopt, grads: dict, state) -> tuple:
    """A ZeRO rank's ``exp_avg`` and ``exp_avg_sq`` after its first step
    against Adam's first moments of the DDP-averaged ``grads``: the whole
    flat grads summed by one plain all-reduce over the optimizer's group,
    scaled by 1 / dp, and cut to this rank's slice of every bucket;
    ``(m error, v error)``, each ``||got - want|| / ||want||``."""
    import torch.distributed as dist
    from apex_tpu_torch.optimizers._flatten import ravel_span

    lay = zopt._layout
    flat = ravel_span(grads, lay, 0, lay.padded)
    dist.all_reduce(flat, group=zopt._group())
    flat = flat * (1.0 / dist.get_world_size(zopt._group()))
    g = torch.cat([flat[off:off + n] for off, n in zopt._my_spans(lay)])
    m = (1.0 - zopt.beta1) * g
    v = (1.0 - zopt.beta2) * g * g

    def rel(got, want) -> float:
        return float((got - want).norm() / want.norm().clamp(min=1e-30))

    return rel(state.exp_avg, m), rel(state.exp_avg_sq, v)


def rank_zero() -> dict:
    """A rank's ZeRO-1 steps (``zero_config``) on its half of the batch
    over gloo on the card, its moments after the first checked by
    :func:`zero_moments_err`, then a step whose grads rank 1 poisons with
    a NaN: the finite flag reduced over "data" must make both ranks
    skip."""
    torch, kern = _rank_setup()
    import torch.distributed as dist

    rank = dist.get_rank()
    cfg, init_state, tokens = gpt_small_setup(torch, DIST_LAYERS)
    rows = tokens.shape[0] // dist.get_world_size()
    poison = {"on": False}

    def sync(grads):
        if poison["on"] and rank == 1:
            name = next(iter(grads))
            grads = dict(grads, **{name: grads[name].clone()})
            grads[name].view(-1)[0] = float("nan")
        return grads

    zopt = zero_config().build_optimizer()
    step = gpt_trainer(torch, cfg, init_state,
                       tokens[rank * rows:(rank + 1) * rows], 1e-4,
                       grad_sync=sync, optimizer=zopt, finite_axes="data")
    launches = {}
    losses, times, grads = timed_steps(torch, kern, step, 1,
                                       f"rank {rank} zero", launches,
                                       layers=DIST_LAYERS)
    st = step.opt_state
    moments = zero_moments_err(torch, zopt, grads, st)
    del grads
    more, more_times, _ = timed_steps(torch, kern, step, ZERO_STEPS - 1,
                                      f"rank {rank} zero, later", launches,
                                      layers=DIST_LAYERS)
    losses, times = losses + more, times + more_times
    out = {"losses": [float(x) for x in losses], "launches": launches,
           "ms": median_ms(times), "state_bytes": state_bytes(torch, st),
           "shard": st.master.numel(), "moments": moments}
    before = _grads_digest(step.params)
    scale, count = float(step.carry["ls"].loss_scale), int(st.step)
    poison["on"] = True
    kern.reset_launches()
    _, finite, _ = step()
    torch.cuda.synchronize()
    add_counts(launches, kern.LAUNCHES)
    out["overflow"] = {
        "finite": bool(finite), "kept": _grads_digest(step.params) == before,
        "step": int(st.step) == count,
        "scale": (scale, float(step.carry["ls"].loss_scale))}
    del step
    torch.cuda.empty_cache()
    return out


def rank_syncbn() -> dict:
    """SyncBatchNorm over "data" at one ResNet-50 BN shape, 2 x 128 images
    and a 96 + 160 split, against the whole batch normalized on this rank
    alone: forward, input grads, weight and bias grads summed over the
    ranks, running statistics; and the times of both (gloo over
    loopback)."""
    torch, kern = _rank_setup()
    import torch.distributed as dist
    from apex_tpu_torch.parallel import SyncBatchNorm

    rank = dist.get_rank()
    n, c, h, w = SYNCBN_SHAPE
    full = (n * dist.get_world_size(), c, h, w)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = (torch.randn(full, device="cuda", generator=gen) * 2 + 0.5
         ).contiguous(memory_format=torch.channels_last)
    dy = torch.randn(full, device="cuda", generator=gen
                     ).contiguous(memory_format=torch.channels_last)

    def run(bn, xs, dys):
        xs = xs.detach().clone().requires_grad_(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bn(xs)
        (out * dys).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), xs.grad, 1e3 * (time.perf_counter() - t0)

    def rel(a, b) -> float:
        return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))

    out = {}
    for case, splits in (("even", (n, n)), ("uneven", SYNCBN_UNEVEN)):
        lo = sum(splits[:rank])
        rows = slice(lo, lo + splits[rank])
        # each timed on its second call, after a warm one; the
        # statistics of the first are what the checks read
        ref = SyncBatchNorm(c, device="cuda")
        o_ref, dx_ref, _ = run(ref, x, dy)
        ms_ref = run(SyncBatchNorm(c, device="cuda"), x, dy)[2]
        bn = SyncBatchNorm(c, axis_name="data", device="cuda")
        o, dx, _ = run(bn, x[rows], dy[rows])
        ms = run(SyncBatchNorm(c, axis_name="data", device="cuda"),
                 x[rows], dy[rows])[2]
        dw, db = bn.weight.grad.clone(), bn.bias.grad.clone()
        dist.all_reduce(dw)
        dist.all_reduce(db)
        out[case] = {
            "rows": splits[rank], "ms": ms, "ms_one_rank": ms_ref,
            "errs": {"out": rel(o, o_ref[rows]), "dx": rel(dx, dx_ref[rows]),
                     "dweight": rel(dw, ref.weight.grad),
                     "dbias": rel(db, ref.bias.grad),
                     "running_mean": rel(bn.running_mean, ref.running_mean),
                     "running_var": rel(bn.running_var, ref.running_var)}}
    return out


def dist_ranks(torch, kern, card: str, zero_losses, zero_bytes,
               zero_total: int, pool) -> dict:
    """``pool``'s two processes on the one card over gloo (CUDA tensors;
    a correctness leg: its times are gloo over loopback, not a speed of
    anything multi-GPU): DDP on 4 x 1024 a rank against the world-1 step
    on 8 x 1024 (the averaged loss within ``TOL_TRAIN_LOSS``, the grads
    within ``TOL_TRAIN_GRAD``, both ranks' grads bit for bit alike); ZeRO
    at world 2 (each rank half of world 1's state, the losses within
    ``TOL_TRAIN_LOSS`` of world 1's ZeRO run, step 0's moments within
    ``TOL_ZERO_MOMENTS`` of the DDP-averaged grads') and a NaN on rank 1 making
    both ranks skip; ``SyncBatchNorm`` at a ResNet-50 BN shape, even and
    uneven, against the whole batch within ``TOL_SYNCBN``. Returns both
    ranks' launches."""
    print(f"dist_ranks: {DIST_WORLD} processes on one card over gloo; "
          f"this torch's gloo takes CUDA tensors in "
          f"{', '.join(GLOO_CUDA_OPS)}, so no check falls back to world 1;"
          f" times below are gloo over loopback [{card}]")
    ddp = pool.run(rank_ddp, timeout=DIST_TIMEOUT)
    zero = pool.run(rank_zero, timeout=DIST_TIMEOUT)
    bn = pool.run(rank_syncbn, timeout=DIST_TIMEOUT)
    launches = {}
    for out in ddp + zero:
        add_counts(launches, out["launches"])

    loss = sum(o["losses"][0] for o in ddp) / DIST_WORLD
    full = ddp[0]["full_loss"]
    g_err, g_leaf = ddp[0]["grad_err"]
    check(len({o["digest"] for o in ddp}) == 1,
          "dist_ranks: the two ranks' synced grads differ")
    check(abs(loss - full) <= TOL_TRAIN_LOSS and g_err <= TOL_TRAIN_GRAD,
          f"dist_ranks: two-rank DDP loss {loss} against the one-rank "
          f"step's {full}, grads {g_leaf} {g_err:.3g}")
    print(f"dist_ranks: DDP over gloo (GPT-small's widths at {DIST_LAYERS} "
          f"layers), 2 x {TRAIN_BH[0] // DIST_WORLD} x "
          f"{TRAIN_ATTN[1]}: mean loss {loss:.6f} against the world-1 step's"
          f" {full:.6f} on 8 x {TRAIN_ATTN[1]} (|diff| {abs(loss - full):.3g},"
          f" tol {TOL_TRAIN_LOSS}); averaged grads against it, worst leaf "
          f"{g_leaf}: {g_err:.4g} (tol {TOL_TRAIN_GRAD}); both ranks' grads "
          f"bit for bit alike; step {ddp[0]['ms']:.1f} ms, the bucketed "
          f"sync alone {ddp[0]['sync_ms']:.1f} ms (gloo over loopback) "
          f"[{card}]")

    losses = [sum(o["losses"][i] for o in zero) / DIST_WORLD
              for i in range(ZERO_STEPS)]
    err = max(abs(a - b) for a, b in zip(losses, zero_losses))
    # each rank's shard is half of the world-1 vector (padded to even)
    halves = all(o["shard"] == -(-zero_total // DIST_WORLD) for o in zero)
    moments = [o["moments"] for o in zero]
    m_err = max(max(mv) for mv in moments)
    check(err <= TOL_TRAIN_LOSS and halves and m_err <= TOL_ZERO_MOMENTS,
          f"dist_ranks: ZeRO at world 2 losses {losses} against world 1's "
          f"{zero_losses} ({err:.3g}), state bytes "
          f"{[o['state_bytes'] for o in zero]} against {zero_bytes}, step "
          f"0's (m, v) by rank against the DDP-averaged grads' {moments}")
    print(f"dist_ranks: ZeRO over gloo at world 2: step 0's moments against "
          f"Adam's first moments of the DDP-averaged grads, (m, v) by rank "
          f"{moments} (relative norm, tol {TOL_ZERO_MOMENTS}); mean losses "
          f"{losses} against world 1's {zero_losses} (max |diff| {err:.3g}, "
          f"tol {TOL_TRAIN_LOSS}); state {zero[0]['state_bytes']} bytes a rank "
          f"against {zero_bytes} at world 1 (a shard of "
          f"{zero[0]['shard']} elements); step {zero[0]['ms']:.1f} ms "
          f"(gloo over loopback) [{card}]")
    flows = [o["overflow"] for o in zero]
    skipped = all(not f["finite"] and f["kept"] and f["step"]
                  and f["scale"][1] == 0.5 * f["scale"][0] for f in flows)
    check(skipped, f"dist_ranks: a NaN on rank 1 did not make both ranks "
                   f"skip: {flows}")
    print(f"dist_ranks: a NaN in rank 1's grads: both ranks' finite flag "
          f"false, params and step count kept, the scale "
          f"{flows[0]['scale'][0]:g} -> {flows[0]['scale'][1]:g} on both")

    for case in ("even", "uneven"):
        worst = max(max(o[case]["errs"].values()) for o in bn)
        check(worst <= TOL_SYNCBN,
              f"dist_ranks: SyncBatchNorm ({case}) against the whole batch: "
              f"{[o[case]['errs'] for o in bn]} > {TOL_SYNCBN}")
        print(f"dist_ranks: SyncBatchNorm, {case} "
              f"{' + '.join(str(o[case]['rows']) for o in bn)} images of "
              f"{SYNCBN_SHAPE[1:]} (fp32, NCHW channels-last) against the "
              f"{sum(o[case]['rows'] for o in bn)} on one rank: worst "
              f"{worst:.3g} (tol {TOL_SYNCBN}, of the largest magnitude; "
              f"forward, input grads, weight and bias grads, running "
              f"statistics); forward + backward "
              f"{bn[0][case]['ms']:.1f} ms a rank (gloo over loopback) "
              f"against {bn[0][case]['ms_one_rank']:.1f} for the whole "
              f"batch on one rank [{card}]")
    return launches


# -- tensor parallelism: two ranks on the card over gloo --------------------
TP_WORLD = 2
TP_BATCH = 4               # 4 x 1024, the same batch on both ranks
TP_STEPS = 3
TP_LR = 1e-4
TP_LEGS = {"plain": (False, False), "sp": (True, False),
           "overlap": (True, True)}
# tp = 2 against the one-rank tp = 1 step on the same weights and batch,
# bf16 compute: each Row layer's partial products are rounded to bf16
# before the sum (the reference's order), the whole products after it,
# so the two differ by a bf16 rounding of each partial; the loss is the
# mean of 4096 token losses. Grads as in TOL_TRAIN_GRAD: the worst leaf's
# ||got - want|| / ||want||
TOL_TP_LOSS = 2e-3
TOL_TP_GRAD = 3e-2
# the 2-layer d-64 fp32 model whose overlap path must equal its fused SP
# path bit for bit (2 x 128 tokens)
TP_FP32 = dict(vocab_size=512, hidden_size=64, num_layers=2,
               num_attention_heads=4, max_position_embeddings=128)
TP_HEADS = (TP_BATCH, 12 // TP_WORLD, 1024, 64)   # B1-B3 at 6 local heads
# the tensor, pipeline and hybrid legs run GPT-small's widths at a cut
# depth (gloo stages every hop through the host: fewer layers, fewer
# copies), every check the same; the pipeline keeps 4 for the
# interleaved leg's 4 stages
TP_LAYERS = 2
PP_LAYERS = 4
HYBRID_LAYERS = 2


def _leaf_norms(torch, got: dict, want: dict) -> dict:
    """``{name: (||got - want||^2, ||want||^2)}`` as floats."""
    return {n: (float(((got[n].float() - w.float()) ** 2).sum()),
                float((w.float() ** 2).sum())) for n, w in want.items()}


def _worst_leaf(per_rank) -> tuple:
    """The worst leaf's relative norm over the ranks' ``_leaf_norms`` (a
    shard's squares summed over the ranks: the gathered leaf's norm)."""
    return max((math.sqrt(sum(r[n][0] for r in per_rank)
                          / max(sum(r[n][1] for r in per_rank), 1e-60)), n)
               for n in per_rank[0])


def rank_tp(ref_path: str) -> dict:
    """A rank of the tensor group: GPT-small's shards from seed 0, three
    legs of ``TP_STEPS`` steps on the batch rank 0 broadcasts, step 0's
    grads against the tp = 1 step's (``ref_path``) and the plain leg's,
    the overlap leg's metrics and hop bytes, a NaN step, and the fp32
    bit-for-bit check of the ring."""
    torch, kern = _rank_setup(TP_WORLD)
    import numpy as np
    import torch.distributed as dist
    from apex_tpu_torch._bridge import split_tp_state
    from apex_tpu_torch.models import GPTConfig, GPTModel
    from apex_tpu_torch.observability import ingraph
    from apex_tpu_torch.transformer.tensor_parallel import (
        broadcast_data, collective_matmul)

    rank = dist.get_rank()
    ref = torch.load(ref_path, map_location="cuda")
    cfg, init_state, _ = gpt_small_setup(torch, TP_LAYERS)
    mine = ref["tokens"] if rank == 0 else torch.zeros_like(ref["tokens"])
    tokens = broadcast_data(["tokens"], {"tokens": mine})["tokens"]
    shard = split_tp_state(init_state, cfg, TP_WORLD, rank)
    want = split_tp_state(ref["grads"], cfg, TP_WORLD, rank)
    out = {"tokens": int(tokens.sum()), "legs": {}}
    del init_state, ref
    # the ring's hops, counted (the library's own hop, wrapped)
    hops = {"bytes": 0}
    real_hop = collective_matmul._Ring.hop

    def counted_hop(ring, t):
        hops["bytes"] += t.numel() * t.element_size()
        return real_hop(ring, t)

    collective_matmul._Ring.hop = counted_hop

    def poison(grads):
        if poison.on and rank == 1:
            grads["layers.0.fc1.weight"][0, 0] = float("nan")
        return grads

    poison.on = False
    base = None
    for leg, (sp, ov) in TP_LEGS.items():
        lcfg = dataclasses.replace(cfg, tensor_model_parallel_size=TP_WORLD,
                                   sequence_parallel=sp, tp_comm_overlap=ov)
        step = gpt_trainer(torch, lcfg, shard, tokens, TP_LR,
                           grad_sync=poison, finite_axes=("tensor",))
        launches = {}
        hops["bytes"] = 0
        losses, times, grads0 = timed_steps(
            torch, kern, step, TP_STEPS, f"tp_gpt rank {rank} {leg}",
            launches, layers=TP_LAYERS)
        res = {"losses": [float(x) for x in losses],
               "ms": median_ms(times), "launches": launches,
               "ref": _leaf_norms(torch, grads0, want),
               "hop_bytes_step": hops["bytes"] / TP_STEPS}
        if base is None:
            base = {n: g.detach().clone() for n, g in grads0.items()}
        else:
            res["plain"] = _leaf_norms(torch, grads0, base)
        del grads0
        if ov:
            shard_shape = (TP_BATCH, TRAIN_ATTN[1] // TP_WORLD,
                           cfg.hidden_size)
            hops["bytes"] = 0
            with torch.no_grad(), ingraph.collecting() as col:
                step.model.loss(tokens, tokens)
                metrics = col.freeze().as_floats()
            res["fwd_hop_bytes"] = hops["bytes"]
            res["metrics"] = metrics
            res["fwd_bytes"] = step.model.tp_overlap_fwd_bytes(shard_shape)
            # a NaN in rank 1's grads: both ranks skip
            before = {n: p.detach().clone() for n, p in step.params.items()}
            scale = float(step.carry["ls"].loss_scale)
            count = int(step.opt_state.step)
            poison.on = True
            _, finite, _ = step()
            poison.on = False
            res["nan_step"] = {
                "finite": bool(finite),
                "scale": (scale, float(step.carry["ls"].loss_scale)),
                "kept": all(torch.equal(p.detach(), before[n])
                            for n, p in step.params.items()),
                "count": (count, int(step.opt_state.step))}
            del before
        out["legs"][leg] = res
        del step
        torch.cuda.empty_cache()
    del base, want, shard

    # fp32 at tp 2: the ring against the fused SP path, bit for bit
    small = GPTConfig(compute_dtype=torch.float32,
                      tensor_model_parallel_size=TP_WORLD,
                      sequence_parallel=True, **TP_FP32)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, TP_FP32["vocab_size"], (2, 128))).to("cuda")
    runs = []
    for ov in (False, True):
        m = GPTModel(dataclasses.replace(small, tp_comm_overlap=ov),
                     device="cuda").init(torch.Generator().manual_seed(0))
        loss = m.loss(toks, toks)
        loss.backward()
        runs.append((loss.detach(), {n: p.grad for n, p in
                                     m.named_parameters()}))
    (l_f, g_f), (l_o, g_o) = runs
    out["fp32_same"] = {"loss": bool(torch.equal(l_f, l_o))}
    out["fp32_same"].update({n: bool(torch.equal(g_f[n], g_o[n]))
                             for n in g_f})
    out["fp32_max_diff"] = max(float((g_f[n] - g_o[n]).abs().max())
                               for n in g_f)
    collective_matmul._Ring.hop = real_hop
    del runs, g_f, g_o
    torch.cuda.empty_cache()
    return out


def check_local_heads(torch, fa, kern, card: str) -> None:
    """B1-B3 at a tp = 2 rank's attention shape ``TP_HEADS`` (GPT-small's
    6 local heads, bf16, causal) against their plain versions, with the
    limits of ``check_flash_train``."""
    b, h, s, d = TP_HEADS
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v, do = (torch.randn((b * h, s, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    tol = tol_for(torch, torch.bfloat16)
    out_k, lse_k = kern.flash_fwd(q, k, v, True, scale)
    out_p, lse_p = fa._flash_fwd_plain(q, k, v, True, scale)
    errs = {"flash_fwd": close(torch, [(out_k, out_p)], tol, fwd_slack(
        torch, fa, q, k, v, True, scale))}
    compare_lse(torch, lse_k, lse_p, TOL_LSE, "flash_fwd at 6 local heads")
    delta = (do.float() * out_p.float()).sum(dim=-1)
    args = (q, k, v, do, lse_p, delta, True, scale)
    errs["flash_bwd_dq"] = close(torch, [(kern.flash_bwd_dq(*args),
                                          fa._flash_bwd_dq_plain(*args))],
                                 tol)
    dk_k, dv_k = kern.flash_bwd_dkv(*args)
    dk_p, dv_p = fa._flash_bwd_dkv_plain(*args)
    errs["flash_bwd_dkv"] = close(torch, [(dk_k, dk_p), (dv_k, dv_p)], tol)
    torch.cuda.synchronize()
    for kname, (err, share) in errs.items():
        check(share <= 1, f"{kname} at {TP_HEADS}: err {err:.3g}, "
                          f"{share:.3g} x the limit {tol}")
    print(f"tp_gpt: B1-B3 at a rank's attention shape {TP_HEADS} (bf16, "
          f"causal) against their plain versions, max_abs_err and share of "
          f"the limit {tol}: " + ", ".join(
              f"{kname} {err:.3g}, {share:.3g}"
              for kname, (err, share) in errs.items()) + f" [{card}]")


def tp_gpt(torch, fa, kern, card: str, pool) -> dict:
    """Tensor parallelism at tp 2: the one-rank tp = 1 reference step,
    B1-B3 at the local heads, then ``rank_tp`` on ``pool``'s two
    processes of the card over gloo (a correctness leg: its times are gloo over loopback,
    no speed of anything multi-GPU). Returns both ranks' launches."""
    import shutil
    import tempfile

    cfg, init_state, tokens = gpt_small_setup(torch, TP_LAYERS)
    tokens = tokens[:TP_BATCH].contiguous()
    step = gpt_trainer(torch, cfg, init_state, tokens, TP_LR)
    ref_loss, _, grads = step()
    ref_loss = float(ref_loss)
    store = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    ref_path = f"{store}/ref.pt"
    torch.save({"tokens": tokens.cpu(),
                "grads": {n: g.detach().cpu() for n, g in grads.items()}},
               ref_path)
    del step, grads, init_state
    torch.cuda.empty_cache()
    check_local_heads(torch, fa, kern, card)

    try:
        outs = pool.run(rank_tp, ref_path, timeout=DIST_TIMEOUT)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    check(all(o["tokens"] == int(tokens.sum()) for o in outs),
          "tp_gpt: broadcast_data did not hand rank 1 rank 0's batch")
    launches = {}
    for out in outs:
        for leg in TP_LEGS:
            add_counts(launches, out["legs"][leg]["launches"])
    print(f"tp_gpt: GPT-small's widths at {TP_LAYERS} layers, tp "
          f"{TP_WORLD}, {TP_WORLD} processes on "
          f"one card over gloo (the ring's hops staged through host "
          f"tensors), {TP_BATCH} x {TRAIN_ATTN[1]} from broadcast_data, "
          f"{TP_STEPS} steps a leg; limits: loss {TOL_TP_LOSS}, grads "
          f"{TOL_TP_GRAD} (worst leaf's relative norm) [{card}]")
    for leg in TP_LEGS:
        legs = [o["legs"][leg] for o in outs]
        l0 = legs[0]["losses"]
        check(all(r["losses"] == l0 for r in legs),
              f"tp_gpt {leg}: the ranks' losses differ: "
              f"{[r['losses'] for r in legs]}")
        g_err, g_leaf = _worst_leaf([r["ref"] for r in legs])
        check(abs(l0[0] - ref_loss) <= TOL_TP_LOSS and g_err <= TOL_TP_GRAD,
              f"tp_gpt {leg}: step 0's loss {l0[0]} against tp = 1's "
              f"{ref_loss}, grads {g_leaf} {g_err:.3g}")
        line = (f"tp_gpt {leg}: losses {l0}; step 0 against the tp = 1 "
                f"step: loss {l0[0]:.6f} vs {ref_loss:.6f} (|diff| "
                f"{abs(l0[0] - ref_loss):.3g}), grads worst leaf {g_leaf} "
                f"{g_err:.4g}")
        if "plain" in legs[0]:
            p_err, p_leaf = _worst_leaf([r["plain"] for r in legs])
            p_loss = outs[0]["legs"]["plain"]["losses"][0]
            check(abs(l0[0] - p_loss) <= TOL_TP_LOSS and p_err <= TOL_TP_GRAD,
                  f"tp_gpt {leg} against plain TP: loss {l0[0]} vs "
                  f"{p_loss}, grads {p_leaf} {p_err:.3g}")
            line += (f"; against plain TP: loss |diff| "
                     f"{abs(l0[0] - p_loss):.3g}, grads worst leaf {p_leaf} "
                     f"{p_err:.4g}")
        line += (f"; launches a rank over {TP_STEPS} steps "
                 f"{[r['launches'] for r in legs]}; step "
                 f"{[round(r['ms'], 1) for r in legs]} ms by rank (host "
                 f"clock, gloo over loopback), ring hops "
                 f"{legs[0]['hop_bytes_step']:.0f} bytes a step [{card}]")
        print(line)
    for r, out in enumerate(outs):
        ov = out["legs"]["overlap"]
        got = ov["metrics"].get("tp/collective_bytes")
        check(got == ov["fwd_bytes"] == ov["fwd_hop_bytes"]
              and ov["metrics"].get("tp/overlap_chunks") == TP_WORLD,
              f"tp_gpt rank {r}: tp/collective_bytes {got}, "
              f"tp_overlap_fwd_bytes {ov['fwd_bytes']}, the forward's hops "
              f"{ov['fwd_hop_bytes']} bytes, metrics {ov['metrics']}")
        nan = ov["nan_step"]
        check(not nan["finite"] and nan["kept"]
              and nan["count"][0] == nan["count"][1]
              and nan["scale"][1] == 0.5 * nan["scale"][0],
              f"tp_gpt rank {r}: a NaN in rank 1's grads did not skip the "
              f"step: {nan}")
        same = out["fp32_same"]
        check(all(same.values()),
              f"tp_gpt rank {r}: the fp32 overlap path differs from the "
              f"fused SP path: {[n for n, v in same.items() if not v]}, "
              f"max |diff| {out['fp32_max_diff']:.3g}")
    ov = outs[0]["legs"]["overlap"]
    print(f"tp_gpt overlap: tp/collective_bytes "
          f"{ov['metrics']['tp/collective_bytes']:.0f} = "
          f"tp_overlap_fwd_bytes {ov['fwd_bytes']} = the bytes the "
          f"forward's ring hops moved {ov['fwd_hop_bytes']} (a rank); a NaN "
          f"in rank 1's grads: both ranks' flag false, params and step "
          f"count kept, the scale {ov['nan_step']['scale'][0]:g} -> "
          f"{ov['nan_step']['scale'][1]:g}; a 2-layer d-64 fp32 model at tp "
          f"{TP_WORLD}: the overlap path's loss and "
          f"{len(outs[0]['fp32_same']) - 1} grads bit for bit the fused SP "
          f"path's on both ranks [{card}]")
    return launches


# -- pipeline parallelism: ranks on the card over gloo ----------------------
PP_WORLD = 2
PP_MICRO = (4, 2)          # M microbatches of 2 x 1024: train's 8 x 1024
PP_MICRO_LONG = 8          # the memory check's second M (16 x 1024)
PP_STEPS = 3
PP_LR = 1e-4
PP_SCALE = 2.0 ** 12       # the loss scale of train's step
PP_CHUNKS = 2              # the interleaved leg: 4 stages of 1 layer
# 1F1B's peak memory on a rank at M 8 against M 4: as many microbatches in
# flight (pp - rank), so only the token tensors of 4 more microbatches
# (16 KiB each) and the allocator's rounding may add. The all-forward
# order keeps every microbatch's graph, so its peak must grow by at
# least half of what 4 more microbatches' graphs take (one microbatch's:
# the two orders' peaks at M 4 apart, over the microbatches they hold
# apart)
PP_PEAK_SLACK = 64 << 20
PP_GROWTH_SHARE = 0.5
# the hybrid trainer: tp 2 x pp 2 x dp 1 (four ranks), M 2 microbatches of
# 2 x 1024 (tp_gpt's 4 x 1024), 2 steps; held to the tp = 1 step within
# TOL_TP_LOSS and TOL_TP_GRAD
HYBRID_TP, HYBRID_PP = 2, 2
HYBRID_MICRO = (2, 2)
HYBRID_STEPS = 2


def pp_launches(L: int, stages: int, rank: int, chunks: int, M: int) -> dict:
    """A pipeline rank's launches for one forward and backward of ``M``
    microbatches: each of its layers runs each flash kernel once a
    microbatch and each LayerNorm kernel twice, the last stage the final
    LayerNorm too (no recompute)."""
    layers = L // (stages * chunks) * chunks
    last = stages - 1 == rank
    ln = M * (2 * layers + int(last))
    return {"flash_fwd": M * layers, "flash_bwd_dq": M * layers,
            "flash_bwd_dkv": M * layers, "ln_fwd": ln, "ln_bwd": ln}


def check_pp_counts(counts: dict, want: dict, what: str) -> None:
    for name, n in want.items():
        check(counts[name] == n,
              f"{what}: {name} launched {counts[name]} times, not {n}")


def _grads_by_name(torch, sg, shg, ids) -> dict:
    """The schedule's chunk grads (``"<j>.<leaf>"``, chunk by chunk) and
    shared grads under the model's parameter names."""
    out = {}
    for c, grads in enumerate(sg):
        for name, g in grads.items():
            j, leaf = name.split(".", 1)
            out[f"layers.{ids[c][int(j)]}.{leaf}"] = g
    for name, g in shg.items():
        if isinstance(g, dict):
            out.update({f"{name}.{k}": v for k, v in g.items()})
        else:
            out[name] = g
    return out


def _compare(torch, got: dict, want: dict) -> dict:
    """``{name: (bit for bit, ||got - want|| / ||want||, max |got -
    want|, sha256 of got's bytes)}`` over ``got``'s names."""
    out = {}
    for n, g in got.items():
        w = want[n].to(g.device, torch.float32)
        d = g.float() - w
        out[n] = (bool(torch.equal(g.float(), w)),
                  float(d.norm() / w.norm().clamp(min=1e-30)),
                  float(d.abs().max()),
                  hashlib.sha256(g.detach().float().cpu().numpy().tobytes()
                                 ).hexdigest())
    return out


def rank_pp(ref_path: str) -> dict:
    """A pipeline rank of GPT-small's widths at pp 2 (seed 0,
    ``PP_LAYERS`` layers, half a stage):
    step 0's 1F1B grads against the one-rank schedule's (``ref_path``),
    the all-forward order and the interleaved schedule against 1F1B, the
    peak memory of both orders at M 4 and 8, ``PP_STEPS`` training steps
    (FusedAdam, DynamicLossScale) and a NaN step."""
    torch, kern = _rank_setup(pp=PP_WORLD)
    import numpy as np
    import torch.distributed as dist
    from apex_tpu_torch._bridge import pipeline_layers
    from apex_tpu_torch.amp import DynamicLossScale, all_finite
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc
    from torch.utils._pytree import tree_leaves

    rank = dist.get_rank()
    # on the host: the peaks below are the schedules' own
    ref = torch.load(ref_path, map_location="cpu")
    cfg, init_state, tokens = gpt_small_setup(torch, PP_LAYERS)
    model = GPTModel(cfg, device="cuda")
    model.load_state_dict(init_state)
    del init_state
    L = cfg.num_layers
    M, mb = PP_MICRO
    seq = tokens.shape[1]
    batches = {M: tokens.reshape(M, mb, seq), PP_MICRO_LONG: torch.from_numpy(
        np.random.RandomState(1).randint(0, cfg.vocab_size, (
            PP_MICRO_LONG, mb, seq))).to("cuda")}
    out = {"runs": {}, "launches": {}}

    def run(name: str, chunks: int, memory_efficient: bool, m: int):
        toks = batches[m]
        stage, embed_fn, head_fn, split, shared_of = model.pipeline_fns(
            PP_WORLD * chunks, toks)
        stages = split(model)
        mine = [stages[c * PP_WORLD + rank] for c in range(chunks)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kern.reset_launches()
        t0 = time.perf_counter()
        if chunks == 1:
            loss, (sg, shg) = \
                sc.forward_backward_pipelining_without_interleaving(
                    stage, toks, mine[0], loss_fn=head_fn,
                    shared_params=shared_of(model), embed_fn=embed_fn,
                    grad_scale=PP_SCALE, memory_efficient=memory_efficient)
            sg = [sg]
        else:
            loss, (sg, shg) = sc.forward_backward_pipelining_with_interleaving(
                stage, toks, mine, loss_fn=head_fn, num_model_chunks=chunks,
                shared_params=shared_of(model), embed_fn=embed_fn,
                grad_scale=PP_SCALE, memory_efficient=memory_efficient)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        counts = dict(kern.LAUNCHES)
        check_pp_counts(counts, pp_launches(L, PP_WORLD, rank, chunks, m),
                        f"pp_gpt rank {rank} {name}")
        add_counts(out["launches"], counts)
        out["runs"][name] = {"loss": float(loss), "ms": ms,
                             "peak": torch.cuda.max_memory_allocated(),
                             "counts": counts}
        return float(loss), _grads_by_name(
            torch, sg, shg, pipeline_layers(L, PP_WORLD, rank, chunks))

    # each order's grads against the one-rank schedule's, with digests
    # (the interleaved leg holds other layers than 1F1B's on a rank)
    out["ref_loss"] = float(ref["loss"])
    for name, chunks, efficient in (("1f1b", 1, True),
                                    ("allfwd", 1, False),
                                    ("interleaved", PP_CHUNKS, True)):
        _, g = run(name, chunks, efficient, M)
        out[name] = _compare(torch, g, ref["grads"])
        del g
    del ref
    run("1f1b_long", 1, True, PP_MICRO_LONG)
    run("allfwd_long", 1, False, PP_MICRO_LONG)
    torch.cuda.empty_cache()

    # training steps on this rank's stage (the other stage's layers to
    # the meta device) and the shared params
    stage_fn, embed_fn, head_fn, split, shared_of = model.pipeline_fns(
        PP_WORLD, batches[M])
    stages = split(model)
    stages[1 - rank].to("meta")
    mine, shared = stages[rank], shared_of(model)
    params = (dict(mine.named_parameters()),
              {k: dict(m.named_parameters()) for k, m in shared.items()})
    opt, scaler = FusedAdam(lr=PP_LR), DynamicLossScale(init_scale=PP_SCALE)
    state, carry = opt.init(params), {"ls": scaler.init(device="cuda")}

    def step(poison: bool = False):
        ls = carry["ls"]
        loss, grads = sc.forward_backward_pipelining_without_interleaving(
            stage_fn, batches[M], mine, loss_fn=head_fn,
            shared_params=shared, embed_fn=embed_fn,
            grad_scale=ls.loss_scale)
        if poison and rank == 1:
            next(iter(grads[0].values())).view(-1)[0] = float("nan")
        finite = all_finite(grads, axis_names=("pipe",))
        carry["ls"] = scaler.update(ls, finite)
        opt.step(grads, state, params, grads_finite=finite)
        return loss, finite

    losses, times = [], []
    for i in range(PP_STEPS):
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        loss, finite = step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = dict(kern.LAUNCHES)
        check_pp_counts(counts, pp_launches(L, PP_WORLD, rank, 1, M),
                        f"pp_gpt rank {rank} step {i}")
        check(bool(finite) and bool(torch.isfinite(loss)),
              f"pp_gpt rank {rank} step {i}: loss {float(loss)} or grads "
              "not finite")
        add_counts(out["launches"], counts)
        losses.append(float(loss))
    out["losses"], out["ms"] = losses, median_ms(times)
    before = [p.detach().clone() for p in tree_leaves(params)]
    scale, count = float(carry["ls"].loss_scale), int(state.step)
    kern.reset_launches()
    _, finite = step(poison=True)
    add_counts(out["launches"], kern.LAUNCHES)
    out["nan"] = {"finite": bool(finite),
                  "scale": (scale, float(carry["ls"].loss_scale)),
                  "kept": all(torch.equal(a, b.detach()) for a, b in
                              zip(before, tree_leaves(params))),
                  "count": (count, int(state.step))}
    del model, mine, shared, params, state, before
    torch.cuda.empty_cache()
    return out


def _peak_mib(run: dict) -> float:
    return run["peak"] / 2 ** 20


def pp_gpt(torch, kern, card: str, pool) -> dict:
    """Pipeline parallelism at pp 2: the one-rank schedule's step 0 (the
    reference), then ``rank_pp`` on ``pool``'s two processes over gloo
    (a correctness leg: its times are gloo over loopback and one card, no
    speed of anything multi-GPU). Returns both ranks' launches."""
    import shutil
    import tempfile
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc

    cfg, init_state, tokens = gpt_small_setup(torch, PP_LAYERS)
    M, mb = PP_MICRO
    model = GPTModel(cfg, device="cuda")
    model.load_state_dict(init_state)
    del init_state
    toks = tokens.reshape(M, mb, tokens.shape[1])
    loss, grads = sc.forward_backward_no_pipelining(
        lambda p, t: model.loss(t, t), toks, dict(model.named_parameters()),
        grad_scale=PP_SCALE)
    store = tempfile.mkdtemp(prefix="chip_smoke_pp_")
    ref_path = f"{store}/ref.pt"
    torch.save({"loss": loss.cpu(),
                "grads": {n: g.detach().cpu() for n, g in grads.items()}},
               ref_path)
    del model, grads
    torch.cuda.empty_cache()

    try:
        outs = pool.run(rank_pp, ref_path, timeout=DIST_TIMEOUT)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    launches = {}
    for out in outs:
        add_counts(launches, out["launches"])
    print(f"pp_gpt: GPT-small's widths at {PP_LAYERS} layers, pp {PP_WORLD} "
          f"({cfg.num_layers // PP_WORLD} layers a stage), "
          f"{PP_WORLD} processes on one card over gloo (the stage hops "
          f"staged through host tensors), {M} microbatches of {mb} x "
          f"{tokens.shape[1]}, bf16 over fp32 params, grad scale "
          f"{PP_SCALE:g}; limits: loss {TOL_TRAIN_LOSS}, grads "
          f"{TOL_TRAIN_GRAD} (each leaf's relative norm) [{card}]")
    ref_loss = outs[0]["ref_loss"]
    l0 = {o["runs"]["1f1b"]["loss"] for o in outs}
    check(len(l0) == 1, f"pp_gpt: the ranks' losses differ: {l0}")
    (l0,) = l0
    digests = {}
    for key in ("1f1b", "allfwd", "interleaved"):
        rows = [r for o in outs for r in o[key].items()]
        check(len({n for n, _ in rows}) == len(gpt_leaf_names(PP_LAYERS)),
              f"pp_gpt {key}: {len({n for n, _ in rows})} grad leaves")
        stage = [v for n, v in rows if n.startswith("layers.")]
        shared = [(n, v) for n, v in rows if not n.startswith("layers.")]
        worst = max(v[1] for _, v in rows)
        check(worst <= TOL_TRAIN_GRAD,
              f"pp_gpt {key} against the one-rank schedule: grads "
              f"{sorted(rows, key=lambda r: -r[1][1])[:3]}")
        digests[key] = {}
        for n, v in rows:
            digests[key].setdefault(n, set()).add(v[3])
        by_name: dict = {}
        for n, v in shared:
            by_name.setdefault(n, []).append(v)
        line = (f"pp_gpt {key} against the one-rank schedule: stage leaves "
                f"bit for bit {sum(v[0] for v in stage)} of {len(stage)} "
                f"(worst relative norm {max(v[1] for v in stage):.3g}, max "
                f"|diff| {max(v[2] for v in stage):.3g}); shared leaves on "
                f"both ranks " + ", ".join(
                    f"{n} " + ("bit for bit" if all(v[0] for v in vs) else
                               f"{max(v[1] for v in vs):.3g} (max |diff| "
                               f"{max(v[2] for v in vs):.3g})")
                    for n, vs in by_name.items()))
        if key != "1f1b":
            same = sum(digests[key][n] == digests["1f1b"][n]
                       for n in digests["1f1b"])
            line += (f"; against 1F1B's grads: {same} of "
                     f"{len(digests['1f1b'])} leaves bit for bit")
            got = {o["runs"][key]["loss"] for o in outs}
            check(all(abs(x - l0) <= TOL_TRAIN_LOSS for x in got),
                  f"pp_gpt {key}: loss {got} against 1F1B's {l0}")
        print(line + f" [{card}]")
    check(all(len(d) == 1 for d in digests["1f1b"].values()),
          "pp_gpt: the pipeline ranks' shared grads differ")
    check(abs(l0 - ref_loss) <= TOL_TRAIN_LOSS,
          f"pp_gpt: step 0's loss {l0} against the one-rank {ref_loss}")
    print(f"pp_gpt: step 0's loss {l0!r} against the one-rank schedule's "
          f"{ref_loss!r} (|diff| {abs(l0 - ref_loss):.3g}); the all-forward"
          f" order {outs[0]['runs']['allfwd']['loss']!r}, interleaved at "
          f"{PP_CHUNKS} chunks a rank "
          f"{outs[0]['runs']['interleaved']['loss']!r} [{card}]")
    M2 = PP_MICRO_LONG
    for r, o in enumerate(outs):
        runs = o["runs"]
        grow_1f1b = runs["1f1b_long"]["peak"] - runs["1f1b"]["peak"]
        grow_all = runs["allfwd_long"]["peak"] - runs["allfwd"]["peak"]
        held = M - min(PP_WORLD - r, M)
        per_mb = (runs["allfwd"]["peak"] - runs["1f1b"]["peak"]) / max(held, 1)
        check(grow_1f1b <= PP_PEAK_SLACK
              and grow_all >= PP_GROWTH_SHARE * (M2 - M) * per_mb > 0,
              f"pp_gpt rank {r}: peak MiB 1F1B {_peak_mib(runs['1f1b'])} -> "
              f"{_peak_mib(runs['1f1b_long'])}, all-forward "
              f"{_peak_mib(runs['allfwd'])} -> "
              f"{_peak_mib(runs['allfwd_long'])}")
        print(f"pp_gpt rank {r}: peak memory (torch.cuda.max_memory_"
              f"allocated, MiB) at M {M} and {M2}: 1F1B "
              f"{_peak_mib(runs['1f1b']):.1f} -> "
              f"{_peak_mib(runs['1f1b_long']):.1f} (+{grow_1f1b / 2**20:.1f},"
              f" slack {PP_PEAK_SLACK / 2**20:.0f}), all-forward "
              f"{_peak_mib(runs['allfwd']):.1f} -> "
              f"{_peak_mib(runs['allfwd_long']):.1f} "
              f"(+{grow_all / 2**20:.1f}; a microbatch's graph "
              f"{per_mb / 2**20:.1f}); launches a step "
              f"{runs['1f1b']['counts']} (interleaved "
              f"{runs['interleaved']['counts']}); schedule ms (host clock, "
              f"gloo over loopback) 1F1B {runs['1f1b']['ms']:.1f} (the "
              f"first call, warm-up included), all-forward "
              f"{runs['allfwd']['ms']:.1f}, interleaved "
              f"{runs['interleaved']['ms']:.1f} [{card}]")
    for r, o in enumerate(outs):
        nan = o["nan"]
        check(o["losses"] == outs[0]["losses"],
              f"pp_gpt: the ranks' step losses differ "
              f"{[x['losses'] for x in outs]}")
        check(not nan["finite"] and nan["kept"]
              and nan["count"][0] == nan["count"][1]
              and nan["scale"][1] == 0.5 * nan["scale"][0],
              f"pp_gpt rank {r}: a NaN in rank 1's grads did not skip the "
              f"step: {nan}")
    nan = outs[0]["nan"]
    print(f"pp_gpt: {PP_STEPS} steps (FusedAdam lr {PP_LR}, "
          f"DynamicLossScale): losses {outs[0]['losses']} on both ranks; "
          f"step ms by rank {[round(o['ms'], 1) for o in outs]} (host "
          f"clock, gloo over loopback); a NaN in rank 1's grads: both "
          f"ranks' flag false, params and step count kept, the scale "
          f"{nan['scale'][0]:g} -> {nan['scale'][1]:g} [{card}]")
    return launches


def gpt_leaf_names(layers: int) -> list:
    """GPT-small's parameter names at ``layers`` layers (4 embedding and
    final LayerNorm leaves, 12 a layer)."""
    names = ["embedding.word.weight", "embedding.position",
             "final_ln.weight", "final_ln.bias"]
    return names + [f"layers.{i}.{m}.{leaf}"
                    for i in range(layers)
                    for m in ("ln1", "qkv", "proj", "ln2", "fc1", "fc2")
                    for leaf in ("weight", "bias")]


def hybrid_config():
    """GPT-small's widths at ``HYBRID_LAYERS`` layers through
    ``TrainConfig`` at tp 2 x pp 2: O2 (bf16 compute,
    fp32 params), Adam at lr ``TP_LR`` with no weight decay."""
    from apex_tpu_torch.config import (BatchConfig, ModelConfig,
                                       OptimizerConfig, ParallelConfig,
                                       TrainConfig)
    M, mb = HYBRID_MICRO
    return TrainConfig(
        model=ModelConfig(name="gpt", **gpt_small_at(HYBRID_LAYERS)),
        parallel=ParallelConfig(tensor_model_parallel_size=HYBRID_TP,
                                pipeline_model_parallel_size=HYBRID_PP),
        batch=BatchConfig(global_batch_size=M * mb, micro_batch_size=mb),
        optimizer=OptimizerConfig(name="adam", lr=TP_LR, weight_decay=0.0),
        opt_level="O2")


def rank_hybrid(ref_path: str) -> dict:
    """A rank of ``GPTHybridTrainer`` at tp 2 x pp 2 from seed 0: step 0's
    grads (the trainer's schedule on its initial state) against the tp = 1
    step's cut to this rank, ``HYBRID_STEPS`` steps with their launches,
    and a NaN in global rank 1's grads."""
    torch, kern = _rank_setup()
    import torch.distributed as dist
    from apex_tpu_torch._bridge import (pipeline_layers, split_pipeline_state,
                                        split_tp_state)
    from apex_tpu_torch.training import GPTHybridTrainer
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel import schedules as sc
    from torch.utils._pytree import tree_leaves

    cfg = hybrid_config()
    ps.destroy_model_parallel()
    mesh = cfg.initialize_mesh()
    rank = dist.get_rank()
    tp_rank = ps.get_tensor_model_parallel_rank()
    pp_rank = ps.get_pipeline_model_parallel_rank()
    trainer = GPTHybridTrainer(cfg, mesh, init_scale=PP_SCALE, device="cuda")
    state = trainer.init_state(torch.Generator().manual_seed(0))
    ref = torch.load(ref_path, map_location="cuda")
    M, mb = HYBRID_MICRO
    tokens = ref["tokens"].to("cuda").reshape(M, mb, -1)
    mcfg = trainer.model.cfg
    want = split_tp_state(ref["grads"], mcfg, HYBRID_TP, tp_rank)
    del ref
    stage_fn, embed_fn, head_fn, _, _ = trainer.model.pipeline_fns(
        HYBRID_PP, tokens)
    kern.reset_launches()
    loss0, (sg, shg) = sc.forward_backward_pipelining_without_interleaving(
        stage_fn, tokens, state[0], loss_fn=head_fn, shared_params=state[1],
        embed_fn=embed_fn, grad_scale=state[3].loss_scale)
    torch.cuda.synchronize()
    out = {"launches": dict(kern.LAUNCHES), "loss0": float(loss0),
           "coords": (pp_rank, tp_rank)}
    got = _grads_by_name(torch, [sg], shg, pipeline_layers(
        mcfg.num_layers, HYBRID_PP, pp_rank))
    out["ref"] = _leaf_norms(torch, got, {n: want[n] for n in got})
    del got, want, sg, shg
    step = trainer.jit_train_step()
    losses, times, counts = [], [], []
    for i in range(HYBRID_STEPS):
        torch.cuda.synchronize()
        kern.reset_launches()
        t0 = time.perf_counter()
        loss, *state = step(*state, tokens, tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts.append(dict(kern.LAUNCHES))
        add_counts(out["launches"], kern.LAUNCHES)
        check_pp_counts(counts[-1], pp_launches(
            mcfg.num_layers, HYBRID_PP, pp_rank, 1, M),
            f"hybrid_gpt rank {rank} step {i}")
        losses.append(float(loss))
    out.update(losses=losses, counts=counts, ms=[1e3 * t for t in times])
    # a NaN in global rank 1's grads: every rank skips
    real = sc._Run.grads

    def poisoned(run):
        chunks, shared = real(run)
        if dist.get_rank() == 1:
            next(iter(chunks[0].values())).view(-1)[0] = float("nan")
        return chunks, shared

    before = [p.detach().clone() for p in tree_leaves(
        trainer.param_tree(state[0], state[1]))]
    scale, count = float(state[3].loss_scale), int(state[2].step)
    sc._Run.grads = poisoned
    try:
        kern.reset_launches()
        _, *state = step(*state, tokens, tokens)
        add_counts(out["launches"], kern.LAUNCHES)
    finally:
        sc._Run.grads = real
    out["nan"] = {"scale": (scale, float(state[3].loss_scale)),
                  "count": (count, int(state[2].step)),
                  "kept": all(torch.equal(a, b.detach()) for a, b in zip(
                      before, tree_leaves(trainer.param_tree(state[0],
                                                             state[1]))))}
    del trainer, state, before
    torch.cuda.empty_cache()
    return out


def hybrid_gpt(torch, kern, card: str) -> dict:
    """``GPTHybridTrainer`` at tp 2 x pp 2 on four processes of the card
    over gloo (a correctness leg, no multi-GPU speed): the tp = 1 step on
    the same weights and batch as the reference, then ``rank_hybrid``.
    Returns the four ranks' launches."""
    import shutil
    import tempfile
    from apex_tpu_torch.parallel._spawn import RankPool

    cfg, init_state, tokens = gpt_small_setup(torch, HYBRID_LAYERS)
    M, mb = HYBRID_MICRO
    tokens = tokens[:M * mb].contiguous()
    step = gpt_trainer(torch, cfg, init_state, tokens, TP_LR)
    ref_loss, _, grads = step()
    ref_loss = float(ref_loss)
    store = tempfile.mkdtemp(prefix="chip_smoke_hybrid_")
    ref_path = f"{store}/ref.pt"
    torch.save({"tokens": tokens.cpu(),
                "grads": {n: g.detach().cpu() for n, g in grads.items()}},
               ref_path)
    del step, grads, init_state
    torch.cuda.empty_cache()

    world = HYBRID_TP * HYBRID_PP
    t0 = time.perf_counter()
    pool = RankPool(world, backend="gloo", device="cuda",
                    pg_timeout=DIST_TIMEOUT)
    try:
        start_s = time.perf_counter() - t0
        outs = pool.run(rank_hybrid, ref_path, timeout=DIST_TIMEOUT)
    finally:
        pool.close()
        shutil.rmtree(store, ignore_errors=True)
    launches = {}
    for out in outs:
        add_counts(launches, out["launches"])
    l0 = {o["loss0"] for o in outs}
    check(len(l0) == 1, f"hybrid_gpt: the ranks' step-0 losses differ {l0}")
    (l0,) = l0
    # each leaf's squares summed over the ranks that hold it (its tensor
    # shards; the shared leaves' pipeline replicas count alike above and
    # below the line)
    sums: dict = {}
    for o in outs:
        for n, (d, w) in o["ref"].items():
            a, b = sums.get(n, (0.0, 0.0))
            sums[n] = (a + d, b + w)
    g_err, g_leaf = max((math.sqrt(d / max(w, 1e-60)), n)
                        for n, (d, w) in sums.items())
    check(len(sums) == len(gpt_leaf_names(HYBRID_LAYERS)),
          f"hybrid_gpt: {len(sums)} grad leaves came back")
    check(abs(l0 - ref_loss) <= TOL_TP_LOSS and g_err <= TOL_TP_GRAD,
          f"hybrid_gpt: step 0's loss {l0} against tp = 1's {ref_loss}, "
          f"grads {g_leaf} {g_err:.3g}")
    check(all(o["losses"] == outs[0]["losses"] for o in outs)
          and abs(outs[0]["losses"][0] - l0) <= TOL_TP_LOSS,
          f"hybrid_gpt: the ranks' losses {[o['losses'] for o in outs]} "
          f"(step 0's schedule {l0})")
    for r, o in enumerate(outs):
        nan = o["nan"]
        check(nan["kept"] and nan["count"][0] == nan["count"][1]
              and nan["scale"][1] == 0.5 * nan["scale"][0],
              f"hybrid_gpt rank {r}: a NaN in rank 1's grads did not skip "
              f"the step: {nan}")
    print(f"hybrid_gpt: GPTHybridTrainer from TrainConfig (O2, adam lr "
          f"{TP_LR}) at tp {HYBRID_TP} x pp {HYBRID_PP} x dp 1, {world} "
          f"processes on one card over gloo, {M} microbatches of {mb} x "
          f"{tokens.shape[1]}; step 0 against the tp = 1 step on the same "
          f"weights and batch: loss {l0!r} vs {ref_loss!r} (|diff| "
          f"{abs(l0 - ref_loss):.3g}, tol {TOL_TP_LOSS}), grads worst leaf "
          f"{g_leaf} {g_err:.4g} (tol {TOL_TP_GRAD}); losses "
          f"{outs[0]['losses']} on every rank; pool started in "
          f"{start_s:.1f} s [{card}]")
    for o in outs:
        print(f"hybrid_gpt rank (pp, tp) {o['coords']}: launches a step "
              f"{o['counts'][0]}; step ms {[round(t, 1) for t in o['ms']]} "
              f"(host clock, gloo over loopback) [{card}]")
    nan = outs[0]["nan"]
    print(f"hybrid_gpt: a NaN in rank 1's grads: every rank's params and "
          f"step count kept, the scale {nan['scale'][0]:g} -> "
          f"{nan['scale'][1]:g} on all {world} [{card}]")
    return launches


# -- context, expert and spatial parallelism; checkpoints -------------------
CP_WORLD = 2
CP_SEED = 20
# ring and Ulysses against the one-rank kernel and its plain twin, relative
# norm of each of out, dq, dk, dv (bf16 in and out): a bf16 rounding of
# each output is ~2**-9 of its norm, the kernel's bf16 tensor-core
# backward ~3e-3 from the fp32 plain one (TOL_LONG_DQKV's 1e-2 allows it)
TOL_CP = 1e-2
MOE = dict(hidden_size=768, ffn_hidden_size=3072, num_experts=8,
           capacity_factor=1.25)
MOE_TOKENS = 8 * 1024
MOE_AUX_WEIGHT = 0.01
# against the one-process routing, relative norm: fp32 the same math with
# GEMMs batched otherwise; bf16 a rounding of the slots and outputs
TOL_MOE = {"float32": 1e-5, "bfloat16": 1e-2}
# ||out - dense|| / ||dense|| against moe_dense in fp32: bf16 rounds the
# expert weights, the FFN's hidden and the output (the CPU tests' bf16
# limit)
TOL_MOE_DENSE = {"float32": 1e-5, "bfloat16": 2e-2}
# (N, H, W, C_in, C_out, stride): ResNet-50's 3x3 at res2 and the
# 128-channel stride-2 conv of res3's first block
SPATIAL_CONVS = ((32, 56, 56, 64, 64, 1), (32, 56, 56, 128, 128, 2))
# fp32 convolutions on the shards and halos against the dense one (TF32
# off), relative norm: cuDNN may pick other algorithms and sum in another
# order. The output and input grads sum 3 x 3 x C terms; the weight grad
# sums N x H x W (100352 at res2, two shards' partials added), whose
# rounding grows as the square root of the count, ~2e-5 of its norm
TOL_SPATIAL = {"out": 1e-5, "dx": 1e-5, "dw": 1e-4}
CKPT_STEPS = 5             # straight; saves at CKPT_SAVE_AT
CKPT_SAVE_AT = 3
CKPT_DROPOUT_STEP = 4      # the last step draws dropout from the tracker
ZERO_CKPT_STEPS = 2
WATCH_ENGINE = dict(max_seqs=2, max_len=256, prefill_len=128)
WATCH_PROMPTS = (100, 37)
WATCH_NEW = 16


def _rel(torch, got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp(min=1e-30))


def rank_cp() -> dict:
    """A rank's ``ring_attention`` (remat on) and ``ulysses_attention`` at
    cp 2 on its 2048 positions of the long-context shape, causal, bf16,
    forward and backward, each run twice (the second timed); its output
    and q/k/v grads against the one-rank kernel and plain twin on the
    whole sequence (comparisons not counted)."""
    torch, kern = _rank_setup(cp=CP_WORLD)
    import torch.distributed as dist
    from apex_tpu_torch.ops.flash_attention import flash_attention
    from apex_tpu_torch.transformer.context_parallel import (
        ring_attention, ulysses_attention)

    rank = dist.get_rank()
    b, h, s, d = LONG_SHAPE
    n = s // CP_WORLD
    gen = torch.Generator(device="cuda").manual_seed(CP_SEED)
    q, k, v, dy = (torch.randn(LONG_SHAPE, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    mine = slice(rank * n, (rank + 1) * n)
    out = {"launches": {"ring": {}, "ulysses": {}}}

    def run(what, fn):
        xs = [t[:, :, mine].contiguous().requires_grad_(True)
              for t in (q, k, v)]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kern.reset_launches()
        t0 = time.perf_counter()
        o = fn(*xs, "context", causal=True)
        o.backward(dy[:, :, mine])
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        add_counts(out["launches"][what], kern.LAUNCHES)
        return ([o.detach()] + [x.grad for x in xs], ms,
                torch.cuda.max_memory_allocated() / 2 ** 20)

    runs = {}
    for what, fn in (("ring", ring_attention), ("ulysses", ulysses_attention)):
        run(what, fn)
        runs[what] = run(what, fn)
    # the references on the whole sequence, this rank's slice of them
    refs = {}
    xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    o = flash_attention(*xs, causal=True)
    o.backward(dy)
    refs["kernel"] = [t[:, :, mine] for t in [o.detach()]
                      + [x.grad for x in xs]]
    plain = [torch.empty_like(t) for t in (q, q, k, v)]
    for i in range(b):
        xs = [t[i:i + 1].clone().requires_grad_(True) for t in (q, k, v)]
        o = flash_attention(*xs, causal=True, use_kernel=False)
        o.backward(dy[i:i + 1])
        for dst, src in zip(plain, [o.detach()] + [x.grad for x in xs]):
            dst[i:i + 1] = src
    refs["plain"] = [t[:, :, mine] for t in plain]
    names = ("out", "dq", "dk", "dv")
    for what, (got, ms, peak) in runs.items():
        out[what] = {"ms": ms, "peak_mib": peak, "errs": {
            ref: {nm: (_rel(torch, g, w), max_err(torch, g, w))
                  for nm, g, w in zip(names, got, want)}
            for ref, want in refs.items()}}
    chunk = nbytes_of(k[:, :, mine])
    out["hop_bytes"] = 2 * chunk                      # k and v a hop
    out["a2a_bytes"] = chunk * (CP_WORLD - 1) // CP_WORLD   # sent a tensor
    del q, k, v, dy, refs, plain, runs, xs, o
    torch.cuda.empty_cache()
    return out


def moe_dense(torch, params: dict, x, num_experts: int,
              capacity_factor: float, **_) -> tuple:
    """The reference's dense check, written apart from the layer: ``x``'s
    tokens routed top-1 by the fp32 softmax of the router, each expert's
    FFN (its tanh-gelu by the formula) in fp32 on the first ``C`` tokens
    it gets, later ones left at 0. Returns ``(out, aux, dropped)``."""
    n, E = x.shape[0], num_experts
    C = max(1, math.ceil(n * capacity_factor / E))
    xf = x.float()
    gates = torch.softmax(xf @ params["router"]["weight"].float().T, -1)
    expert = gates.argmax(-1)
    gate = gates.gather(1, expert[:, None])[:, 0]
    w = {k: v.float() for k, v in params["experts"].items()}
    out, dropped = torch.zeros_like(xf), 0
    for e in range(E):
        mine = (expert == e).nonzero()[:, 0]
        dropped += max(int(mine.numel()) - C, 0)
        mine = mine[:C]
        h1 = xf[mine] @ w["wi"][e].T + w["bi"][e]
        h1 = 0.5 * h1 * (1 + torch.tanh(math.sqrt(2 / math.pi)
                                        * (h1 + 0.044715 * h1 ** 3)))
        out[mine] = gate[mine, None] * (h1 @ w["wo"][e].T + w["bo"][e])
    frac = torch.bincount(expert, minlength=E).float() / n
    return out, E * torch.sum(frac * gates.mean(0)), dropped


def rank_ep_spatial(zero_dir: str) -> dict:
    """A rank's ``ExpertParallelMLP`` (fp32, bf16) against its tokens
    routed on one process over a one-rank group and against
    :func:`moe_dense`, ``spatial_conv2d`` at
    ``SPATIAL_CONVS`` against the dense conv, then ZeRO-1 at dp 2 for
    ``ZERO_CKPT_STEPS`` steps and ``save_checkpoint`` into ``zero_dir``."""
    torch, kern = _rank_setup()
    import torch.distributed as dist
    import torch.nn.functional as F
    from apex_tpu_torch.checkpoint import save_checkpoint
    from apex_tpu_torch.optimizers._flatten import ravel
    from apex_tpu_torch.parallel.spatial import spatial_conv2d
    from apex_tpu_torch.transformer.expert_parallel import ExpertParallelMLP

    rank, world = dist.get_rank(), dist.get_world_size()
    # every rank makes every group, in one order
    solo = [dist.new_group([r]) for r in range(world)][rank]
    out = {"moe": {}, "spatial": [], "launches": {}}
    E = MOE["num_experts"]
    lo, hi = rank * E // world, (rank + 1) * E // world
    for dtype in (torch.float32, torch.bfloat16):
        full = ExpertParallelMLP(**MOE).init(torch.Generator().manual_seed(7),
                                             device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(100 + rank)
        x = torch.randn(MOE_TOKENS, MOE["hidden_size"], generator=gen,
                        device="cuda").to(dtype)
        res = {}
        for what, group, experts in (("ep", dist.group.WORLD, slice(lo, hi)),
                                     ("ep", dist.group.WORLD, slice(lo, hi)),
                                     ("one", solo, slice(None))):
            layer = ExpertParallelMLP(**MOE, axis_name=group)
            params = {"router": {"weight": full["router"]["weight"].clone()
                                 .requires_grad_(True)},
                      "experts": {k: v[experts].clone().requires_grad_(True)
                                  for k, v in full["experts"].items()}}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y, aux = layer(params, x)
            (y.float().square().sum() + MOE_AUX_WEIGHT * aux).backward()
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            with torch.no_grad():
                dropped = MOE_TOKENS - int(layer._route(params, x)[0].sum())
            res[what] = (y.detach(), aux.detach(), params, dropped, ms)
        (y, aux, p, dropped, ms), (y1, aux1, p1, dropped1, ms1) = \
            res["ep"], res["one"]
        experts = {k: v.grad.contiguous() for k, v in p1["experts"].items()}
        for g in experts.values():
            dist.all_reduce(g)
        errs = {"out": _rel(torch, y, y1),
                "aux": abs(float(aux) - float(aux1)),
                "router": _rel(torch, p["router"]["weight"].grad,
                               p1["router"]["weight"].grad)}
        for key, g in experts.items():
            errs[key] = _rel(torch, p["experts"][key].grad, g[lo:hi])
        with torch.no_grad():
            y_d, aux_d, dropped_d = moe_dense(torch, full, x, **MOE)
        dense = {"out": _rel(torch, y.float(), y_d),
                 "aux": abs(float(aux) - float(aux_d))}
        out["moe"][str(dtype).split(".")[-1]] = {
            "errs": errs, "dense": dense,
            "dropped": (dropped, dropped1, dropped_d), "ms": ms,
            "ms_one": ms1, "aux": float(aux)}
        del full, res, p, p1, experts, x, y, y1, y_d
        torch.cuda.empty_cache()

    for N, H, W, cin, cout, stride in SPATIAL_CONVS:
        gen = torch.Generator(device="cuda").manual_seed(H + cin + stride)
        x = torch.randn(N, H, W, cin, generator=gen, device="cuda")
        w = torch.randn(3, 3, cin, cout, generator=gen, device="cuda") * 0.05
        oh, ow = -(-H // stride), -(-W // stride)
        dy = torch.randn(N, oh, ow, cout, generator=gen, device="cuda")
        rows, orows = H // world, oh // world
        got = []
        for _ in range(2):          # the second timed
            xs = x[:, rank * rows:(rank + 1) * rows].clone() \
                .requires_grad_(True)
            ws = w.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o = spatial_conv2d(xs, ws, dist.group.WORLD, stride=stride)
            o.backward(dy[:, rank * orows:(rank + 1) * orows])
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            got = [o.detach(), xs.grad, ws.grad.contiguous()]
        dist.all_reduce(got[2])
        xd, wd = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        ph = max((oh - 1) * stride + 3 - H, 0)
        pw = max((ow - 1) * stride + 3 - W, 0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xc = F.pad(xd.permute(0, 3, 1, 2),
                   (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
        od = F.conv2d(xc, wd.permute(3, 2, 0, 1), stride=stride) \
            .permute(0, 2, 3, 1)
        od.backward(dy)
        torch.cuda.synchronize()
        ms_dense = 1e3 * (time.perf_counter() - t0)
        want = [od.detach()[:, rank * orows:(rank + 1) * orows],
                xd.grad[:, rank * rows:(rank + 1) * rows], wd.grad]
        out["spatial"].append({
            "shape": (N, H, W, cin, cout, stride), "ms": ms,
            "ms_dense": ms_dense,
            "errs": {nm: _rel(torch, g, w_) for nm, g, w_ in
                     zip(("out", "dx", "dw"), got, want)}})
        del x, w, dy, got, want, xd, wd, od, xc
        torch.cuda.empty_cache()

    # ZeRO-1 at dp 2, saved for checkpoint_resume to read at world 1
    cfg, init_state, tokens = gpt_small_setup(torch, DIST_LAYERS)
    per = tokens.shape[0] // world
    zopt = zero_config().build_optimizer()
    step = gpt_trainer(torch, cfg, init_state,
                       tokens[rank * per:(rank + 1) * per], 1e-4,
                       optimizer=zopt, finite_axes="data")
    timed_steps(torch, kern, step, ZERO_CKPT_STEPS, f"rank {rank} zero ckpt",
                out["launches"], layers=DIST_LAYERS)
    st = step.opt_state
    lay = zopt._layout
    # the run's own fp32 params in leaf order: what the natural vector of
    # the resharded master must be
    params_digest = tree_digest(torch, ravel(step.params, lay)[:lay.total])
    t0 = time.perf_counter()
    save_checkpoint(zero_dir, {"opt": st}, ZERO_CKPT_STEPS,
                    host_state={"world": world,
                                "total": zopt._layout.total,
                                "bucket_bytes": ZERO_BUCKET_BYTES})
    out["zero"] = {"save_s": time.perf_counter() - t0,
                   "shard": st.master.numel(), "params": params_digest,
                   "digests": {f: tree_digest(torch, getattr(st, f))
                               for f in ("master", "exp_avg", "exp_avg_sq")}}
    del step, st
    torch.cuda.empty_cache()
    return out


def dist_cp_ep(torch, kern, card: str, zero_dir: str, pool) -> tuple:
    """``cp_attention`` and ``ep_spatial``: ``pool``'s two processes on
    the card over gloo (correctness legs; their times are gloo over loopback, no
    multi-GPU speed). Returns ``(cp launches, ep launches, zero leg)``."""

    t0 = time.perf_counter()
    cp = pool.run(rank_cp, timeout=DIST_TIMEOUT)
    cp_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    ep = pool.run(rank_ep_spatial, zero_dir, timeout=DIST_TIMEOUT)
    ep_s = time.perf_counter() - t1
    cp_launches = {}
    for r, o in enumerate(cp):
        ulysses = o["launches"]["ulysses"]
        add_counts(cp_launches, ulysses)
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            check(ulysses.get(name, 0) == 2,
                  f"cp_attention rank {r}: Ulysses launched {name} "
                  f"{ulysses.get(name, 0)} times in 2 calls, not 2")
        check(sum(o["launches"]["ring"].values()) == 0,
              f"cp_attention rank {r}: the ring launched "
              f"{o['launches']['ring']}")
        for what in ("ring", "ulysses"):
            for ref, errs in o[what]["errs"].items():
                worst = max(e[0] for e in errs.values())
                check(worst <= TOL_CP,
                      f"cp_attention rank {r}: {what} against the one-rank "
                      f"{ref}: {errs} (tol {TOL_CP})")
    for what in ("ring", "ulysses"):
        for ref in ("kernel", "plain"):
            errs = {nm: max(o[what]["errs"][ref][nm][0] for o in cp)
                    for nm in ("out", "dq", "dk", "dv")}
            print(f"cp_attention: {what} at cp {CP_WORLD}, "
                  f"{LONG_SHAPE} bf16 causal, {LONG_SHAPE[2] // CP_WORLD} "
                  f"positions a rank, against the one-rank {ref} on the "
                  f"whole sequence: relative norm (worst rank) "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (tol {TOL_CP}); max |diff| "
                  + ", ".join(f"{k} {max(o[what]['errs'][ref][k][1] for o in cp):.3g}"
                              for k in errs) + f" [{card}]")
        print(f"cp_attention: {what} forward + backward "
              f"{[round(o[what]['ms'], 1) for o in cp]} ms by rank (host "
              f"clock, second call, gloo over loopback), peak "
              f"{[round(o[what]['peak_mib'], 1) for o in cp]} MiB by rank; "
              + (f"B1-B3 launches a rank {cp[0]['launches']['ulysses']} "
                 "over 2 calls"
                 if what == "ulysses" else "no port kernel launched")
              + f" [{card}]")
    print(f"cp_attention: {cp[0]['hop_bytes']} bytes a ring hop (k and v "
          f"chunks), {cp[0]['a2a_bytes']} bytes a rank sends in one "
          f"all-to-all of a {LONG_SHAPE[:2] + (LONG_SHAPE[2] // CP_WORLD,)
                             + LONG_SHAPE[3:]} bf16 shard [{card}]")

    for r, o in enumerate(ep):
        for dt, m in o["moe"].items():
            worst = max(v for k, v in m["errs"].items() if k != "aux")
            check(worst <= TOL_MOE[dt] and m["errs"]["aux"] <= 1e-6
                  and m["dense"]["out"] <= TOL_MOE_DENSE[dt]
                  and m["dense"]["aux"] <= 1e-6
                  and len(set(m["dropped"])) == 1,
                  f"ep_spatial rank {r}: MoE {dt} against one-process "
                  f"routing {m['errs']} (tol {TOL_MOE[dt]}), against the "
                  f"dense reference {m['dense']} (tol {TOL_MOE_DENSE[dt]}), "
                  f"dropped (ep, one process, dense) {m['dropped']}")
        for c in o["spatial"]:
            check(all(e <= TOL_SPATIAL[k] for k, e in c["errs"].items()),
                  f"ep_spatial rank {r}: spatial_conv2d {c['shape']} "
                  f"against the dense conv {c['errs']} (tol {TOL_SPATIAL})")
    for dt in ("float32", "bfloat16"):
        ms = [o["moe"][dt] for o in ep]
        print(f"ep_spatial: ExpertParallelMLP {MOE} at ep {CP_WORLD}, "
              f"{MOE_TOKENS} tokens a rank, {dt}: against the same shards "
              f"routed on one process, worst rank's relative norm "
              + ", ".join(f"{k} {max(m['errs'][k] for m in ms):.3g}"
                          for k in ms[0]["errs"])
              + f" (tol {TOL_MOE[dt]}; aux as |diff|); against the dense "
              f"per-expert fp32 reference, worst rank's out relative norm "
              f"{max(m['dense']['out'] for m in ms):.3g} (tol "
              f"{TOL_MOE_DENSE[dt]}), aux |diff| "
              f"{max(m['dense']['aux'] for m in ms):.3g}; tokens dropped by "
              f"rank {[m['dropped'][0] for m in ms]}; aux "
              f"{[round(m['aux'], 5) for m in ms]}; forward + backward "
              f"{[round(m['ms'], 1) for m in ms]} ms by rank (host clock, "
              f"second call, gloo over loopback) against "
              f"{[round(m['ms_one'], 1) for m in ms]} routed on one process "
              f"[{card}]")
    for i, shape in enumerate(SPATIAL_CONVS):
        cs = [o["spatial"][i] for o in ep]
        print(f"ep_spatial: spatial_conv2d (N, H, W, C_in, C_out, stride) "
              f"{shape} fp32 over 2 height shards against the dense "
              f"F.conv2d: worst relative norm "
              + ", ".join(f"{k} {max(c['errs'][k] for c in cs):.3g}"
                          for k in ("out", "dx", "dw"))
              + f" (tol {TOL_SPATIAL}); forward + backward "
              f"{[round(c['ms'], 2) for c in cs]} ms by rank (host clock, "
              f"halos over gloo) against {cs[0]['ms_dense']:.2f} ms dense on "
              f"one rank [{card}]")
    ep_launches = {}
    for o in ep:
        add_counts(ep_launches, o["launches"])
    zero = {"shard": ep[0]["zero"]["shard"],
            "params": [o["zero"]["params"] for o in ep],
            "digests": [o["zero"]["digests"] for o in ep],
            "save_s": [o["zero"]["save_s"] for o in ep]}
    print(f"cp_attention + ep_spatial: wall seconds cp_attention {cp_s:.1f}"
          f", ep_spatial {ep_s:.1f} (the ZeRO steps and their save "
          f"included)")
    return cp_launches, ep_launches, zero


def ckpt_steps(torch, kern, step, steps, what: str, launches: dict) -> list:
    """Steps ``steps`` (indices of the straight run) of ``step``, dropout
    at ``CKPT_DROPOUT_STEP``, each one's launches checked and added."""
    losses = []
    for i in steps:
        torch.cuda.synchronize()
        kern.reset_launches()
        loss, finite, _ = step(i == CKPT_DROPOUT_STEP)
        torch.cuda.synchronize()
        check_gpt_counts(dict(kern.LAUNCHES), f"{what} step {i}")
        check(bool(finite), f"{what} step {i}: grads not finite")
        add_counts(launches, kern.LAUNCHES)
        losses.append(float(loss))
    return losses


def tree_digest(torch, tree) -> str:
    """sha256 over every leaf's dtype, shape and bits, in tree order."""
    from torch.utils._pytree import tree_leaves
    h = hashlib.sha256()
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.detach().cpu().contiguous().view(-1)
                     .view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(t).encode())
    return h.hexdigest()


def checkpoint_resume(torch, kern, card: str, root: str, zero: dict) -> dict:
    """GPT-small resumed bit for bit through ``save_checkpoint`` and
    ``AsyncCheckpointer`` under a ``FaultPlan``, the dp 2 ZeRO checkpoint
    restored at world 1 through ``reshard_zero_state``, and
    ``watch_checkpoints`` on a dense engine. Returns the launches of the
    training steps and of the watcher's engine."""
    import os
    import warnings
    import numpy as np
    from apex_tpu_torch.checkpoint import (all_steps, read_host_state,
                                           restore_checkpoint,
                                           save_checkpoint, torn_steps)
    from apex_tpu_torch.elastic import AsyncCheckpointer, FaultPlan
    from apex_tpu_torch.elastic.reshard import reshard_zero_state, to_natural
    from apex_tpu_torch.observability import MetricsRegistry
    from apex_tpu_torch.optimizers import ZeroAdamState

    cfg, init_state, tokens = gpt_small_setup(torch)
    launches = {}
    before, after = range(CKPT_SAVE_AT), range(CKPT_SAVE_AT, CKPT_STEPS)
    drop_cfg = dataclasses.replace(cfg, hidden_dropout=TRAIN_DROPOUT,
                                   attention_dropout=TRAIN_DROPOUT)

    def ckpt_trainer(tracker_seed: int):
        """``gpt_trainer``'s step with dropout at ``TRAIN_DROPOUT`` from
        a tracker stream seeded ``tracker_seed``, at the steps that ask."""
        return gpt_trainer(torch, drop_cfg, init_state, tokens, 1e-4,
                           tracker_seed=tracker_seed)

    def fresh():
        step = ckpt_trainer(99)
        with torch.no_grad():
            for p in step.model.parameters():
                p.zero_()
        return step

    straight = ckpt_trainer(1234)
    want = ckpt_steps(torch, kern, straight, range(CKPT_STEPS),
                      "checkpoint_resume straight", launches)
    want_digest = tree_digest(torch, straight.state())
    del straight
    torch.cuda.empty_cache()

    # the synchronous save and restore
    sync_dir = os.path.join(root, "sync")
    run = ckpt_trainer(1234)
    got = ckpt_steps(torch, kern, run, before, "checkpoint_resume", launches)
    t0 = time.perf_counter()
    save_checkpoint(sync_dir, run.state(), CKPT_SAVE_AT, fp32_on_disk=True,
                    host_state={"step": CKPT_SAVE_AT}, keep_last=1)
    save_s = time.perf_counter() - t0
    del run
    resumed = fresh()
    t0 = time.perf_counter()
    tree, host = restore_checkpoint(sync_dir, resumed.state())
    resumed.load(tree)
    restore_s = time.perf_counter() - t0
    got += ckpt_steps(torch, kern, resumed, after, "checkpoint_resume "
                      "restored", launches)
    digest = tree_digest(torch, resumed.state())
    ckpt_bytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(sync_dir) for f in fs)
    check(got == want and digest == want_digest
          and host == {"step": CKPT_SAVE_AT},
          f"checkpoint_resume: losses {got} against the straight run's "
          f"{want}, leaves {'alike' if digest == want_digest else 'differ'}")
    print(f"checkpoint_resume: GPT-small (8 x 1024, FusedAdam, "
          f"DynamicLossScale, bf16 compute over fp32 params, dropout "
          f"{TRAIN_DROPOUT} from the tracker at step {CKPT_DROPOUT_STEP}): "
          f"{CKPT_STEPS} steps straight against {CKPT_SAVE_AT}, "
          f"save_checkpoint (fp32_on_disk, keep_last=1) in {save_s:.2f} s, "
          f"a fresh model, optimizer, scaler and tracker, restore_checkpoint "
          f"in {restore_s:.2f} s, {CKPT_STEPS - CKPT_SAVE_AT} more: losses "
          f"{got} bit for bit, every leaf bit for bit (sha256 "
          f"{digest[:16]}); {ckpt_bytes} bytes on disk (host clock, the "
          f"machine's temporary directory, warm) [{card}]")
    del resumed, tree
    torch.cuda.empty_cache()

    # the asynchronous writer under a fault plan
    async_dir = os.path.join(root, "async")
    plan = FaultPlan(save_errors={CKPT_SAVE_AT: 1}, tear_after_step=CKPT_STEPS)
    reg = MetricsRegistry()
    ck = AsyncCheckpointer(async_dir, keep_last=2, retry_backoff_s=0.05,
                           registry=reg, fault_hook=plan.on_save_attempt,
                           after_save=plan.after_save)
    run = ckpt_trainer(1234)
    got = ckpt_steps(torch, kern, run, before, "checkpoint_resume async",
                     launches)
    t0 = time.perf_counter()
    ck.save(run.state(), CKPT_SAVE_AT, host_state={"step": CKPT_SAVE_AT})
    snap_ms = 1e3 * (time.perf_counter() - t0)
    # the run goes on, writing its params and state in place, while the
    # writer serializes step CKPT_SAVE_AT's snapshot
    got += ckpt_steps(torch, kern, run, after, "checkpoint_resume async",
                      launches)
    ck.save(run.state(), CKPT_STEPS, host_state={"step": CKPT_STEPS})
    ck.drain()
    snap = reg.snapshot()
    steps, torn = all_steps(async_dir), torn_steps(async_dir)
    check(got == want and snap["ckpt/retries"] == 1
          and snap["ckpt/saves"] == 2 and steps == [CKPT_SAVE_AT]
          and torn == [CKPT_STEPS],
          f"checkpoint_resume async: losses {got} against {want}, metrics "
          f"{snap}, committed {steps}, torn {torn}")
    del run
    resumed = fresh()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tree, host = restore_checkpoint(async_dir, resumed.state())
    warned = [str(w.message) for w in caught
              if f"[{CKPT_STEPS}]" in str(w.message)]
    resumed.load(tree)
    got = want[:CKPT_SAVE_AT] + ckpt_steps(
        torch, kern, resumed, after, "checkpoint_resume async restored",
        launches)
    digest = tree_digest(torch, resumed.state())
    check(got == want and digest == want_digest and len(warned) == 1
          and host == {"step": CKPT_SAVE_AT},
          f"checkpoint_resume async: after the torn step, losses {got} "
          f"against {want}, leaves "
          f"{'alike' if digest == want_digest else 'differ'}, warnings "
          f"{[str(w.message) for w in caught]}")
    print(f"checkpoint_resume: AsyncCheckpointer under FaultPlan("
          f"save_errors={{{CKPT_SAVE_AT}: 1}}, tear_after_step={CKPT_STEPS})"
          f": snapshot {snap_ms:.1f} ms on the step thread against serialize "
          f"{snap['ckpt/save_ms_sum'] / max(snap['ckpt/save_ms_count'], 1):.1f}"
          f" ms a save off it (ckpt/save_ms, {snap['ckpt/save_ms_count']:.0f}"
          f" saves), ckpt/bytes {snap['ckpt/bytes']:.0f} over 2 saves, "
          f"ckpt/retries {snap['ckpt/retries']:.0f}, ckpt/saves "
          f"{snap['ckpt/saves']:.0f}; steps {CKPT_SAVE_AT + 1}-{CKPT_STEPS} "
          f"ran while step {CKPT_SAVE_AT} was written; committed {steps}, "
          f"torn {torn}; the restore warned \"{warned[0][:60]}...\" and "
          f"resumed at step {CKPT_SAVE_AT}: losses and every leaf bit for "
          f"bit the straight run's [{card}]")
    del resumed, tree

    # ZeRO-1 at dp 2, restored at world 1
    zero_dir = os.path.join(root, "zero")
    step_z, host = read_host_state(zero_dir)
    total, bb, dp_old = host["total"], host["bucket_bytes"], host["world"]
    shard = zero["shard"]
    like = ZeroAdamState(
        step=torch.zeros((), dtype=torch.int32), bucket_stamp=0,
        **{f: torch.empty(shard * dp_old, device="meta")
           for f in ("master", "exp_avg", "exp_avg_sq")})
    t0 = time.perf_counter()
    tree, _ = restore_checkpoint(zero_dir, {"opt": like})
    glob = tree["opt"]
    shards_ok = all(
        tree_digest(torch, getattr(glob, f).chunk(dp_old)[r]) == d[f]
        for r, d in enumerate(zero["digests"]) for f in d)
    one = reshard_zero_state(glob, total=total, dp_old=dp_old, dp_new=1,
                             bucket_bytes=bb)
    # the master's natural vector on the new grid against the fp32 params
    # the ZeRO run gathered itself (by the optimizer's own layout code)
    natural = tree_digest(torch, to_natural(one.master, total, 1, bb))
    natural_ok = set(zero["params"]) == {natural}
    reshard_s = time.perf_counter() - t0
    check(shards_ok and natural_ok and int(one.step) == ZERO_CKPT_STEPS
          and one.bucket_stamp == bb and step_z == ZERO_CKPT_STEPS,
          f"checkpoint_resume: ZeRO dp {dp_old} -> 1: shards "
          f"{'alike' if shards_ok else 'differ'}, master's natural vector "
          f"{'alike' if natural_ok else 'differ'}, step {int(one.step)}")
    print(f"checkpoint_resume: ZeRO-1 (zero_config, {bb}-byte buckets) at "
          f"dp {dp_old} over gloo, {ZERO_CKPT_STEPS} steps, saved by both "
          f"ranks in {[round(x, 2) for x in zero['save_s']]} s; restored at "
          f"world 1 as the {dp_old} shards' concatenation ({shard} elements "
          f"each, bit for bit each rank's), reshard_zero_state to dp 1: the "
          f"master's natural flat vector bit for bit the ZeRO run's own fp32 "
          f"params after its {ZERO_CKPT_STEPS} steps in leaf order ({total} "
          f"elements, sha256 {natural[:16]}); restore and reshard "
          f"{reshard_s:.1f} s "
          f"(host clock) [{card}]")
    del tree, glob, one

    # the serving watcher on the synchronous leg's checkpoint
    from apex_tpu_torch.models import GPTModel
    from apex_tpu_torch.serving import ServingEngine, watch_checkpoints
    from torch.utils._pytree import tree_map
    target = tree_map(lambda t: t.to("meta") if isinstance(t, torch.Tensor)
                      and t.is_floating_point() else t,
                      fresh().state())
    torch.cuda.empty_cache()
    prompts = [np.random.RandomState(n).randint(0, cfg.vocab_size,
                                                n).tolist()
               for n in WATCH_PROMPTS]

    def stream(engine):
        toks = np.array([engine.prefill(p, i) for i, p in
                         enumerate(prompts)], np.int64)
        out = [toks.tolist()]
        temps = np.zeros(len(prompts), np.float32)
        active = np.ones(len(prompts), bool)
        for _ in range(WATCH_NEW - 1):
            toks = np.asarray(engine.decode(toks, temps, active)).astype(
                np.int64)
            out.append(toks.tolist())
        return out

    engine = ServingEngine(GPTModel(cfg, device="cuda"), init_state,
                           device="cuda", **WATCH_ENGINE)
    before_swap = stream(engine)
    reg = MetricsRegistry()
    kern.reset_launches()
    watcher = watch_checkpoints(engine, sync_dir, target=target,
                                extract=lambda s: s["params"], registry=reg)
    engine.release_slot(0)
    engine.release_slot(1)
    served = stream(engine)
    torch.cuda.synchronize()
    add_counts(launches, kern.LAUNCHES)
    tree, _ = restore_checkpoint(sync_dir, target)
    ref = stream(ServingEngine(GPTModel(cfg, device="cuda"),
                               tree["params"], device="cuda", **WATCH_ENGINE))
    check(watcher.step == CKPT_SAVE_AT and reg.snapshot()["serve/swaps"] == 1
          and served == ref and watcher.poll() is None,
          f"checkpoint_resume: the watcher at step {watcher.step}, "
          f"serve/swaps {reg.snapshot().get('serve/swaps')}, its stream "
          f"{'equals' if served == ref else 'differs from'} the restored "
          f"engine's")
    print(f"checkpoint_resume: watch_checkpoints on a dense ServingEngine "
          f"{WATCH_ENGINE} (bf16 cache) rolled onto committed step "
          f"{watcher.step} (serve/swaps 1, a second poll a no-op): its "
          f"greedy stream of {WATCH_NEW} tokens for prompts of "
          f"{list(WATCH_PROMPTS)} equals that of an engine built on the "
          f"restored weights ({'and differs from' if before_swap != served else 'the same as'}"
          f" the stream before the swap) [{card}]")
    return launches


def profile_step(torch, what: str, fn, card: str, iters: int = 5,
                 top: int = 8) -> tuple:
    """Device busy time of ``fn`` in a ``profile_window`` (CUDA activity
    alone) against its host wall time, and the kernels that take the most
    device time; returns ``(busy ms, device launches)`` a call. ``fn`` is
    called once, then ``iters`` times a window, up to ``PROFILE_TRIES``
    windows."""
    fn()
    torch.cuda.synchronize()
    rows, wall_ms, primers_lost = profile_window(torch, fn, iters,
                                                 f"profile {what}")
    busy_ms = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    print(f"profile {what}: wall {wall_ms:.3f} ms (CUDA activity "
          f"recorded), device busy {busy_ms:.3f} ms = "
          f"{100 * busy_ms / wall_ms:.1f}%, {launches:.0f} device launches "
          f"read, {primers_lost} of {PROFILE_PRIMERS} primer records lost "
          f"[{card}]")
    for key, ms, count in rows[:top]:
        print(f"profile {what}:   {ms:8.4f} ms  x{count:<5.0f} {key[:90]}")
    return busy_ms, launches


def _host_time(torch, fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


# -- the elastic group: ElasticRunner in this process, the launcher ---------
ELASTIC_STEPS = 6
ELASTIC_SAVE_INTERVAL = 2
ELASTIC_MICRO = (1, 8)      # M microbatches of 8 x 1024: train's 8 x 1024
ELASTIC_ROWS = 64           # the token array: 64 rows of 1025 tokens
ELASTIC_DATA_SEED = 7       # the token array's RandomState
ELASTIC_SAMPLER_SEED = 5    # ShardedIndexIterator's seed
ELASTIC_PREEMPT_AT = 3
# every save sleeps this long first (FaultPlan.slow_save_s), so the
# preemption at step 3 lands while step 2's save is being written
ELASTIC_SLOW_SAVE_S = 0.5
ELASTIC_KEEP_LAST = 2
# E2: GPT-small's widths at 2 layers (the gloo host copies of two ranks
# sharing the card), ZeRO-1 Adam at dp 2, rank 1 killed before step 3
E2_LAYERS = 2
E2_KILL = {1: 3}
E2_STEPS = 4
E2_WORKER_FLAG = "--elastic-worker"
E2_ENV = "CHIP_SMOKE_ELASTIC_JOB"
E2_HEARTBEAT_TIMEOUT_S = 180.0
E2_ROUND_TIMEOUT_S = 300.0
E2_GRACE_S = 2.0
# the post-shrink losses against an uninterrupted dp 1 run from step 0:
# steps 1-2 ran at dp 2, whose grads are two half-batch grads averaged
# over gloo (fp32 sums in another order than the full batch's), and Adam
# carries that rounding on, so the limit is the DDP check's
# ``TOL_TRAIN_LOSS``; the same restore replayed in this process is held
# bit for bit
TOL_SHRINK_LOSS = TOL_TRAIN_LOSS


def elastic_config(layers: int = None, zero: bool = False, dp: int = 1):
    """GPT-small (at ``layers`` layers of its widths when given) through
    ``TrainConfig``: tp = pp = 1, O2, Adam at lr ``TP_LR`` without weight
    decay, ZeRO-1 with ``ZERO_BUCKET_BYTES`` buckets when ``zero``."""
    from apex_tpu_torch.config import (BatchConfig, ModelConfig,
                                       OptimizerConfig, ParallelConfig,
                                       TrainConfig)
    M, rows = ELASTIC_MICRO
    return TrainConfig(
        model=ModelConfig(name="gpt", **gpt_small_at(layers)),
        parallel=ParallelConfig(tensor_model_parallel_size=1,
                                pipeline_model_parallel_size=1),
        batch=BatchConfig(global_batch_size=M * rows,
                          micro_batch_size=rows // dp),
        optimizer=OptimizerConfig(name="adam", lr=TP_LR, weight_decay=0.0,
                                  zero=1 if zero else "off"),
        opt_level="O2", ddp_bucket_bytes=ZERO_BUCKET_BYTES if zero else None)


def elastic_data(torch):
    """The elastic legs' input: ``ShardedIndexIterator`` over a seeded
    token array, prefetched to the card by ``PrefetchingIterator`` through
    ``token_batch_fetcher`` (one global batch of ``ELASTIC_MICRO`` a step,
    the same on every rank: a rank takes its data columns in the step)."""
    import numpy as np
    from apex_tpu_torch.elastic import (PrefetchingIterator,
                                        ShardedIndexIterator,
                                        token_batch_fetcher)
    M, rows = ELASTIC_MICRO
    seq = GPT_SMALL["max_position_embeddings"]
    data = np.random.RandomState(ELASTIC_DATA_SEED).randint(
        0, GPT_SMALL["vocab_size"], (ELASTIC_ROWS, seq + 1))
    return PrefetchingIterator(
        ShardedIndexIterator(ELASTIC_ROWS, M * rows,
                             seed=ELASTIC_SAMPLER_SEED),
        token_batch_fetcher(data, M, rows, seq), depth=2, device="cuda")


def state_digests(torch, state) -> dict:
    """sha256 of a trainer state's bytes: the params (the stage and
    shared modules' state dicts), the optimizer state and the loss
    scale."""
    from torch import nn
    from torch.utils._pytree import tree_leaves

    def digest(leaves) -> str:
        h = hashlib.sha256()
        for x in leaves:
            if isinstance(x, torch.Tensor):
                h.update(x.detach().cpu().contiguous().view(-1)
                         .view(torch.uint8).numpy().tobytes())
            else:
                h.update(repr(x).encode())
        return h.hexdigest()[:16]

    params = [t for m in state[:2] if isinstance(m, nn.Module)
              for t in m.state_dict().values()]
    return {"params": digest(params), "optimizer": digest(
        tree_leaves(state[2])), "loss_scale": digest(tree_leaves(state[3]))}


def elastic_fit(torch, kern, cfg, mesh, directory: str, steps: int, *,
                plan=None, checkpointer=None, registry=None,
                final_save: bool = True, digests: bool = True) -> dict:
    """One ``ElasticRunner.fit`` of a fresh ``GPTHybridTrainer`` (seed 0)
    over ``elastic_data``: the result, the losses by step, the data
    cursor, the registry's snapshot, the launches of the run and (with
    ``digests``) the state's sha256s."""
    from apex_tpu_torch.elastic import ElasticRunner
    from apex_tpu_torch.observability.registry import MetricsRegistry
    from apex_tpu_torch.training import GPTHybridTrainer

    reg = registry if registry is not None else MetricsRegistry()
    trainer = GPTHybridTrainer(cfg, mesh, init_scale=PP_SCALE, device="cuda")
    data = elastic_data(torch)
    losses = {}
    runner = ElasticRunner(
        trainer, data, directory, save_interval=ELASTIC_SAVE_INTERVAL,
        keep_last=ELASTIC_KEEP_LAST, fault_plan=plan, registry=reg,
        exit_on_preempt=False, checkpointer=checkpointer,
        final_save=final_save,
        on_step=lambda k, loss: losses.__setitem__(k, loss))
    torch.cuda.synchronize()
    kern.reset_launches()
    t0 = time.perf_counter()
    res = runner.fit(steps, generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    out = {"res": res, "losses": {k: float(v) for k, v in losses.items()},
           "cursor": data.state_dict(), "metrics": reg.snapshot(),
           "registry": reg, "launches": dict(kern.LAUNCHES),
           "s": time.perf_counter() - t0,
           "digests": state_digests(torch, res.state) if digests else None,
           "runner": runner}
    return out


def check_elastic_counts(counts: dict, layers: int, steps: int,
                         what: str) -> None:
    M = ELASTIC_MICRO[0]
    want = {k: steps * v for k, v in pp_launches(layers, 1, 0, 1,
                                                  M).items()}
    check_pp_counts(counts, want, what)


def elastic_resume(torch, kern, card: str, root: str) -> dict:
    """E1: GPT-small at full width under ``ElasticRunner`` (NCCL at world
    1): ``ELASTIC_STEPS`` straight steps; in a fresh directory a
    ``FaultPlan(sigterm_at_step=3, slow_save_s=...)`` preemption, then a
    fresh runner to the end, bit for bit the straight run; then a second
    SIGTERM during a slowed drain raising ``DrainInterrupt`` with the
    previous COMMITTED step intact. Returns the runs' launches."""
    import os
    import shutil
    import signal
    from apex_tpu_torch.checkpoint import latest_step, read_host_state
    from apex_tpu_torch.elastic import (AsyncCheckpointer, DrainInterrupt,
                                        FaultPlan)
    from apex_tpu_torch.observability.registry import MetricsRegistry

    cfg = elastic_config()
    mesh = cfg.initialize_mesh()
    L = cfg.model.num_layers
    launches: dict = {}

    # the straight and resumed runs skip the final save: nothing reads it
    straight = elastic_fit(torch, kern, cfg, mesh, f"{root}/straight",
                           ELASTIC_STEPS, final_save=False)
    check(not straight["res"].preempted
          and straight["res"].step == ELASTIC_STEPS,
          f"elastic E1: the straight run stopped at {straight['res']}")
    check_elastic_counts(straight["launches"], L, ELASTIC_STEPS,
                         "elastic E1 straight run")
    add_counts(launches, straight["launches"])
    shutil.rmtree(f"{root}/straight", ignore_errors=True)

    plan = FaultPlan(sigterm_at_step=ELASTIC_PREEMPT_AT,
                     slow_save_s=ELASTIC_SLOW_SAVE_S)
    first = elastic_fit(torch, kern, cfg, mesh, f"{root}/run",
                        ELASTIC_STEPS, plan=plan, digests=False)
    check(first["res"].preempted
          and first["res"].step == ELASTIC_PREEMPT_AT,
          f"elastic E1: the SIGTERM at step {ELASTIC_PREEMPT_AT} gave "
          f"{first['res']}")
    check_elastic_counts(first["launches"], L, ELASTIC_PREEMPT_AT,
                         "elastic E1 preempted run")
    add_counts(launches, first["launches"])
    second = elastic_fit(torch, kern, cfg, mesh, f"{root}/run",
                         ELASTIC_STEPS, final_save=False)
    res = second["res"]
    check(not res.preempted and res.step == ELASTIC_STEPS
          and res.restored_from == ELASTIC_PREEMPT_AT and not res.resharded,
          f"elastic E1: the resumed run gave {res}")
    check_elastic_counts(second["launches"], L,
                         ELASTIC_STEPS - ELASTIC_PREEMPT_AT,
                         "elastic E1 resumed run")
    add_counts(launches, second["launches"])
    later = {k: v for k, v in straight["losses"].items()
             if k > ELASTIC_PREEMPT_AT}
    same = {"losses": second["losses"] == later,
            "state": second["digests"] == straight["digests"],
            "cursor": second["cursor"] == straight["cursor"]}
    check(all(same.values()),
          f"elastic E1: preempt + resume against straight: {same}; losses "
          f"{second['losses']} against {later}, digests "
          f"{second['digests']} against {straight['digests']}, cursors "
          f"{second['cursor']} against {straight['cursor']}")
    m1, m2 = first["metrics"], second["metrics"]
    save_hist = first["registry"].histogram("ckpt/save_ms")
    m = cfg.model
    print(f"elastic E1: GPT-small (vocab {m.vocab_size}, hidden "
          f"{m.hidden_size}, {L} layers, {m.num_attention_heads} heads, "
          f"{m.max_position_embeddings} positions), "
          f"GPTHybridTrainer at tp = pp = dp = 1 (NCCL at world 1, O2, adam "
          f"lr {TP_LR}) under ElasticRunner, ShardedIndexIterator -> "
          f"PrefetchingIterator(device='cuda') -> token_batch_fetcher, "
          f"{ELASTIC_MICRO[0] * ELASTIC_MICRO[1]} x "
          f"{cfg.model.max_position_embeddings} tokens a step, save_interval "
          f"{ELASTIC_SAVE_INTERVAL} [{card}]")
    print(f"elastic E1: straight losses {straight['losses']} "
          f"({straight['s']:.1f} s); SIGTERM at step {ELASTIC_PREEMPT_AT} "
          f"(slow_save_s {ELASTIC_SLOW_SAVE_S}): preempted at step "
          f"{first['res'].step}, losses {first['losses']}; resumed: "
          f"restored_from {res.restored_from}, losses {second['losses']}; "
          f"params, optimizer state, loss scale (sha256 "
          f"{second['digests']}) and the data cursor {second['cursor']} bit "
          f"for bit the straight run's; launches a run "
          f"{[straight['launches'], first['launches'], second['launches']]}"
          f" [{card}]")
    print(f"elastic E1: resume/restore_ms {m2['resume/restore_ms']:.1f}, "
          f"resume/restored_step {m2['resume/restored_step']:g}, "
          f"resume/resumes {m2['resume/resumes']:g}; the preempted run's "
          f"ckpt/save_ms count {save_hist.count} p50 "
          f"{save_hist.percentile(50):.1f} max {save_hist._max:.1f} (the "
          f"serialize wall a save, {ELASTIC_SLOW_SAVE_S} s of injected "
          f"sleep in each), ckpt/bytes {m1['ckpt/bytes']:g}, ckpt/saves "
          f"{m1['ckpt/saves']:g}, ckpt/retries {m1.get('ckpt/retries', 0):g},"
          f" resume/preempt_exits {m1['resume/preempt_exits']:g}; the "
          f"resumed run's ckpt/save_ms p50 "
          f"{second['registry'].histogram('ckpt/save_ms').percentile(50):.1f}"
          f" (no sleep) [{card}]")
    del straight, first, second, res
    shutil.rmtree(f"{root}/run", ignore_errors=True)
    torch.cuda.empty_cache()

    # a second SIGTERM while the drain writes the final checkpoint, at
    # E2's depth (the leg checks the signal path, not the model)
    drain_cfg = elastic_config(E2_LAYERS)
    drain_dir = f"{root}/drain"
    fired = []

    def hook(step, attempt):
        if step == ELASTIC_PREEMPT_AT and not fired:
            fired.append(step)
            os.kill(os.getpid(), signal.SIGTERM)
        plan.on_save_attempt(step, attempt)

    reg = MetricsRegistry()
    ck = AsyncCheckpointer(drain_dir, keep_last=ELASTIC_KEEP_LAST,
                           registry=reg, fault_hook=hook)
    prev = signal.getsignal(signal.SIGTERM)
    interrupted = None
    try:
        elastic_fit(torch, kern, drain_cfg, mesh, drain_dir, ELASTIC_STEPS,
                    plan=plan, checkpointer=ck, registry=reg, digests=False)
    except DrainInterrupt as e:
        interrupted = str(e)
    committed = latest_step(drain_dir)
    host_step = read_host_state(drain_dir)[1].get("step")
    restored_handler = signal.getsignal(signal.SIGTERM) == prev
    add_counts(launches, kern.LAUNCHES)
    ck.drain()  # the abandoned writer thread, joined before going on
    check(interrupted is not None and fired == [ELASTIC_PREEMPT_AT]
          and committed == ELASTIC_PREEMPT_AT - 1
          and host_step == ELASTIC_PREEMPT_AT - 1 and restored_handler,
          f"elastic E1: a second SIGTERM during the drain: raised "
          f"{interrupted!r}, fired {fired}, latest COMMITTED step "
          f"{committed} (host.json step {host_step}), SIGTERM handler "
          f"restored {restored_handler}")
    print(f"elastic E1: a second SIGTERM during the slowed drain of step "
          f"{ELASTIC_PREEMPT_AT}'s save ({E2_LAYERS} layers of GPT-small's "
          f"widths): DrainInterrupt ({interrupted[:60]}"
          f"...); the latest COMMITTED step then {committed} (host.json "
          f"step {host_step}), the SIGTERM handler restored; launches "
          f"{dict(kern.LAUNCHES)} [{card}]")
    shutil.rmtree(drain_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def elastic_worker() -> None:
    """A rank of E2, started by ``LocalLauncher`` as ``python3
    chip_smoke.py --elastic-worker`` with the multiproc env block and
    ``E2_ENV`` (the checkpoint and result directories, the steps, the
    fault plan): ZeRO-1 GPT at ``E2_LAYERS`` layers under
    ``ElasticRunner``, a heartbeat and a fleet snapshot a step, and a
    JSON result per rank at the end."""
    import os
    import torch
    import torch.distributed as dist
    from apex_tpu_torch import _kernels as kern
    from apex_tpu_torch.elastic import ElasticRunner, FaultPlan, Heartbeat
    from apex_tpu_torch.observability.fleet import FleetPublisher
    from apex_tpu_torch.observability.registry import get_registry
    from apex_tpu_torch.parallel import multiproc
    from apex_tpu_torch.training import GPTHybridTrainer

    entered = time.time()
    t0 = time.perf_counter()
    job = json.loads(os.environ[E2_ENV])
    info = multiproc.initialize_from_env(device="cuda")
    check(info is not None, "elastic worker started without the "
                            "multiproc env")
    kern.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    hb = Heartbeat(info.run_dir)
    hb.beat(0)
    reg = get_registry()
    reg.counter("train/steps")
    pub = FleetPublisher(info.run_dir, rank=info.process_id, registry=reg)
    pub.publish(0, force=True)
    cfg = elastic_config(E2_LAYERS, zero=True, dp=info.num_processes)
    mesh = cfg.initialize_mesh()
    trainer = GPTHybridTrainer(cfg, mesh, init_scale=PP_SCALE, device="cuda")
    losses = {}

    def on_step(k, loss):
        losses[k] = float(loss)
        hb.beat(k)

    runner = ElasticRunner(
        trainer, elastic_data(torch), job["ckpt"],
        save_interval=ELASTIC_SAVE_INTERVAL, keep_last=3,
        fault_plan=FaultPlan.from_json(job["fault"]), on_step=on_step,
        exit_on_preempt=True, publisher=pub)
    kern.reset_launches()
    t1 = time.perf_counter()
    res = runner.fit(job["steps"], generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    snap = reg.snapshot()
    out = {"rank": info.process_id, "world": info.num_processes,
           "backend": info.backend, "losses": losses, "step": res.step,
           "restored_from": res.restored_from,
           "resharded": bool(res.resharded),
           "restore_ms": snap.get("resume/restore_ms"),
           "launches": dict(kern.LAUNCHES),
           "digests": state_digests(torch, res.state),
           "entered": entered, "setup_s": t1 - t0, "fit_s": t2 - t1}
    path = os.path.join(job["results"], f"w{info.num_processes}_rank"
                        f"{info.process_id}.json")
    os.makedirs(job["results"], exist_ok=True)
    with open(path + ".tmp", "w") as f:
        json.dump(out, f)
    os.replace(path + ".tmp", path)
    dist.destroy_process_group()


def elastic_launch(torch, kern, card: str, root: str) -> dict:
    """E2: the port's ``LocalLauncher(num_processes=2, min_processes=1,
    max_restarts=1)`` over ``elastic_worker`` (two processes sharing the
    card over gloo) with ``FaultPlan(kill_process={1: 3})``: rank 1 dies
    at step 3, the gang restarts at world 2, dies again, shrinks to world
    1, and the survivor restores the dp 2 checkpoint at dp 1 through the
    reshard. Then, in this process (NCCL at world 1), the same restore
    replayed from that checkpoint (bit for bit the survivor's losses) and
    an uninterrupted dp 1 run from step 0 (within ``TOL_SHRINK_LOSS``).
    Returns the launches of the survivor and the replays."""
    import os
    import shutil
    from apex_tpu_torch.elastic import FaultPlan, LocalLauncher
    from apex_tpu_torch.observability.registry import MetricsRegistry

    run_dir = f"{root}/e2"
    ckpt, results = f"{run_dir}/ckpt", f"{run_dir}/results"
    job = {"ckpt": ckpt, "results": results, "steps": E2_STEPS,
           "fault": FaultPlan(kill_process=E2_KILL).to_json()}
    reg = MetricsRegistry()
    launcher = LocalLauncher(
        [sys.executable, os.path.abspath(__file__), E2_WORKER_FLAG],
        num_processes=2, min_processes=1, max_restarts=1, run_dir=run_dir,
        restart_backoff_s=0.05, heartbeat_timeout_s=E2_HEARTBEAT_TIMEOUT_S,
        round_timeout_s=E2_ROUND_TIMEOUT_S, grace_s=E2_GRACE_S, poll_s=0.02,
        env={E2_ENV: json.dumps(job)}, registry=reg)
    round_s, round_at = [], []
    real = launcher._run_round

    def timed(world, index):
        round_at.append(time.time())
        t0 = time.perf_counter()
        out = real(world, index)
        round_s.append(time.perf_counter() - t0)
        return out

    launcher._run_round = timed
    report = launcher.run()
    rounds = [(r.world_size, r.cause, r.returncodes) for r in report.rounds]
    if not report.succeeded:
        for name in sorted(os.listdir(f"{run_dir}/logs")):
            with open(f"{run_dir}/logs/{name}") as f:
                print(f"elastic E2 {name}:\n{f.read()[-3000:]}",
                      file=sys.stderr)
    killed = -9
    check(report.succeeded and report.world_size == 1
          and report.restarts == 1 and report.shrinks == 1
          and [r[1] for r in rounds] == ["exit", "exit", "ok"]
          and all(r[2].get(1) == killed for r in rounds[:2]),
          f"elastic E2: LaunchReport {report}")
    with open(report.rounds[0].postmortem) as f:
        pm = json.load(f)
    ranks = pm["ranks"]
    check(pm["culprit_rank"] == 1 and pm["culprit_reason"]
          == "heartbeat_dead", f"elastic E2: the first round's postmortem "
                               f"blames rank {pm['culprit_rank']} "
                               f"({pm['culprit_reason']})")
    with open(f"{results}/w1_rank0.json") as f:
        survivor = json.load(f)
    kill_at = E2_KILL[1]
    restored = kill_at - kill_at % ELASTIC_SAVE_INTERVAL
    check(survivor["resharded"] and survivor["restored_from"] == restored
          and survivor["step"] == E2_STEPS,
          f"elastic E2: the survivor {survivor}")
    view = launcher.fleet.view()
    merged_steps = view["counters"].get("train/steps", {}).get("total")
    check(merged_steps == E2_STEPS - restored,
          f"elastic E2: the aggregator's merged train/steps {merged_steps}")
    print(f"elastic E2: LocalLauncher(num_processes=2, min_processes=1, "
          f"max_restarts=1) over GPT-small's widths at {E2_LAYERS} layers, "
          f"ZeRO-1 Adam (bucket {ZERO_BUCKET_BYTES} bytes), FaultPlan("
          f"kill_process={E2_KILL}); LaunchReport: succeeded "
          f"{report.succeeded}, world_size {report.world_size}, restarts "
          f"{report.restarts}, shrinks {report.shrinks}, rounds (world, "
          f"cause, exit codes) {rounds}; round seconds "
          f"{[round(s, 1) for s in round_s]} [{card}]")
    print(f"elastic E2: round 0's postmortem ({report.rounds[0].postmortem}"
          f"): cause {pm['cause']}, culprit rank {pm['culprit_rank']} "
          f"({pm['culprit_reason']}), ranks "
          f"{[(r['rank'], r['returncode'], r['last_step']) for r in ranks]}"
          f" (rank, exit code before teardown, last step); the "
          f"aggregator's merged train/steps {merged_steps:g} on ranks "
          f"{view['ranks']}; metrics elastic/restarts "
          f"{reg.snapshot()['elastic/restarts']:g}, elastic/shrinks "
          f"{reg.snapshot()['elastic/shrinks']:g}, elastic/world_size "
          f"{reg.snapshot()['elastic/world_size']:g}")
    print(f"elastic E2: the survivor (world 1, {survivor['backend']}) "
          f"restored step {survivor['restored_from']} across dp 2 -> dp 1 "
          f"(FitResult.resharded {survivor['resharded']}) in "
          f"{survivor['restore_ms']:.1f} ms (resume/restore_ms, the "
          f"reshard included), losses {survivor['losses']}, launches "
          f"{survivor['launches']}; its round: "
          f"{survivor['entered'] - round_at[-1]:.1f} s to start Python, "
          f"torch and this script, {survivor['setup_s']:.1f} s to join the "
          f"group and build the trainer, {survivor['fit_s']:.1f} s in fit "
          f"[{card}]")

    # this process, NCCL at world 1: the survivor's restore replayed from
    # the same dp 2 checkpoint, and dp 1 from step 0
    cfg = elastic_config(E2_LAYERS, zero=True)
    mesh = cfg.initialize_mesh()
    launches = dict(survivor["launches"])
    replay_dir = f"{root}/e2_replay"
    step_dir = f"step_{restored:08d}"
    os.makedirs(replay_dir)
    shutil.copytree(f"{ckpt}/{step_dir}", f"{replay_dir}/{step_dir}")
    replay = elastic_fit(torch, kern, cfg, mesh, replay_dir, E2_STEPS,
                         final_save=False)
    add_counts(launches, replay["launches"])
    straight = elastic_fit(torch, kern, cfg, mesh, f"{root}/e2_straight",
                           E2_STEPS, final_save=False)
    add_counts(launches, straight["launches"])
    got = {int(k): v for k, v in survivor["losses"].items()}
    err = max(abs(v - straight["losses"][k]) for k, v in got.items())
    check(replay["res"].resharded and replay["losses"] == got
          and replay["digests"] == survivor["digests"]
          and err <= TOL_SHRINK_LOSS,
          f"elastic E2: the survivor's losses {got} against the replayed "
          f"restore's {replay['losses']} and the uninterrupted dp 1 run's "
          f"{straight['losses']} ({err:.3g}); digests "
          f"{survivor['digests']} against {replay['digests']}")
    print(f"elastic E2: the same restore replayed in this process (NCCL at "
          f"world 1, resharded {replay['res'].resharded}): losses and the "
          f"final state bit for bit the survivor's; against an "
          f"uninterrupted dp 1 run from step 0 (losses "
          f"{straight['losses']}): max |diff| {err:.3g} over the "
          f"post-shrink steps (tol {TOL_SHRINK_LOSS}: steps 1-2 averaged "
          f"two half-batch grads over gloo) [{card}]")
    shutil.rmtree(run_dir, ignore_errors=True)
    shutil.rmtree(replay_dir, ignore_errors=True)
    shutil.rmtree(f"{root}/e2_straight", ignore_errors=True)
    torch.cuda.empty_cache()
    return launches


def elastic(torch, kern, card: str) -> dict:
    """The elastic group: E1 and E2 (see the module docstring), NCCL at
    world 1 in this process around both. Returns their launches."""
    import tempfile
    import torch.distributed as dist
    from apex_tpu_torch.transformer import parallel_state

    launches: dict = {}
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_elastic_") as root:
        dist.init_process_group("nccl", init_method=f"file://{root}/nccl",
                                rank=0, world_size=1)
        try:
            t0 = time.perf_counter()
            add_counts(launches, elastic_resume(torch, kern, card, root))
            t1 = time.perf_counter()
            parallel_state.destroy_model_parallel()
            add_counts(launches, elastic_launch(torch, kern, card, root))
            print(f"elastic: wall seconds E1 {t1 - t0:.1f}, E2 "
                  f"{time.perf_counter() - t1:.1f}")
        finally:
            parallel_state.destroy_model_parallel()
            dist.destroy_process_group()
    return launches


# the observability group (A7a): GPT-small's training step (``train``'s:
# 8 x 1024 tokens, bf16 compute, FusedAdam, DynamicLossScale) under the
# telemetry stack and the numerics watchdog
OBS_LEVELS = ("off", "cheap", "full")
OBS_STEPS = 3              # steps a level after a warm one, levels in turns
OBS_LR = 1e-4
# O2's planted overflow: a mid-stack leaf, the whole of it inf
OBS_PLANT = "layers.5.fc1.weight"
# the allocator's bytes in use read by sample_memory_stats against
# torch.cuda.memory_allocated() read just after it: nothing allocates
# between the two, so they should agree to the byte; 1 MiB allowed
OBS_MEM_SLACK = 1 << 20
# the keys observe_tree records for a tree
OBS_TREE_KEYS = ("nonfinite_count", "abs_max", "l2", "underflow_frac",
                 "first_nonfinite_leaf")
OBS_HYBRID_LAYERS = 2      # O4: GPTHybridTrainer at 2 layers of the widths
OBS_HYBRID_STEPS = 2


def gpt_flops_per_step(cfg, batch: int, seq: int, n_params: int) -> float:
    """``bench.py``'s analytic count (:537-538): 6N + 12 L d seq a token."""
    return batch * seq * (6.0 * n_params
                          + 12.0 * cfg.num_layers * cfg.hidden_size * seq)


def health_keys(payload: dict) -> set:
    return {k for k in payload if k.startswith("health/")}


def tree_keys(*trees) -> set:
    return {f"health/{t}/{k}" for t in trees for k in OBS_TREE_KEYS}


def obs_step(torch, health, ingraph, step, level, extra=None):
    """One step of ``step`` under the policy at ``level`` (None: no policy)
    and a collector: ``(loss, finite, metrics)``."""
    cfg = None if level is None else health.HealthConfig(level=level)
    with health.activate(cfg), ingraph.collecting() as col:
        loss, finite, grads = step(extra=extra)
        metrics = col.freeze()
    del grads
    return loss, finite, metrics


def obs_training(torch, kern, card: str, tmp: str, setup) -> dict:
    """O1: three trainers from one state, at off, cheap and full, a warm
    step then ``OBS_STEPS`` steps each, the levels in turns, through one
    ``StepReporter``; then each level's launches under the profiler and
    the FLOP and memory budgets. Returns the launches."""
    from apex_tpu_torch.observability import (ChromeTraceSink, JSONLSink,
                                              MetricsRegistry, StepReporter,
                                              costs, health, ingraph,
                                              runtime)
    from apex_tpu_torch.utils.timers import Timers

    cfg, init_state, tokens = setup
    batch, seq = tokens.shape
    trainers = {lv: gpt_trainer(torch, cfg, init_state, tokens, OBS_LR)
                for lv in OBS_LEVELS}
    n_params = sum(p.numel() for p in trainers["off"].params.values())
    flops = gpt_flops_per_step(cfg, batch, seq, n_params)
    peak = costs.peak_flops()
    reg = MetricsRegistry()
    runtime.install_compile_listeners(reg)
    timers = Timers()
    watch = health.HealthConfig(level="full", on_nonfinite="raise",
                                dump_dir=f"{tmp}/o1_dumps")
    jsonl, chrome = f"{tmp}/o1.jsonl", f"{tmp}/o1_trace.json"
    reporter = StepReporter(
        [JSONLSink(jsonl), ChromeTraceSink(chrome)], registry=reg,
        timers=timers, capture_spans=True, hooks=[watch.reporter_hook()],
        flops_per_step=flops, peak_flops=peak)
    launches: dict = {}
    losses = {lv: [] for lv in OBS_LEVELS}
    step_ms = {lv: [] for lv in OBS_LEVELS}
    payloads, mfus, mem_gap = [], [], 0
    n = 0
    for i in range(1 + OBS_STEPS):
        for lv in OBS_LEVELS:
            torch.cuda.synchronize()
            kern.reset_launches()
            with health.activate(health.HealthConfig(level=lv)), \
                    ingraph.collecting() as col:
                timers("step").start()
                loss, finite, grads = trainers[lv]()
                timers("step").stop(wait_for=loss)
                metrics = col.freeze()
            del grads
            counts = dict(kern.LAUNCHES)
            check_gpt_counts(counts, f"observability O1 {lv} step {i}")
            add_counts(launches, counts)
            check(bool(finite), f"observability O1 {lv} step {i}: "
                                "grads not finite")
            runtime.sample_memory_stats(reg)
            allocated = torch.cuda.memory_allocated()
            prev = reporter._last_report
            payload = reporter.report(n, metrics=metrics)
            now = reporter._last_report
            if prev is not None:
                want = costs.mfu(flops * (now[0] - prev[0]),
                                 now[1] - prev[1], peak)
                check(payload["perf/mfu"] == want,
                      f"observability O1: perf/mfu {payload['perf/mfu']} "
                      f"is not costs.mfu of the reporter's deltas {want}")
                mfus.append(want)
            gap = abs(payload["memory/bytes_in_use/device0"] - allocated)
            mem_gap = max(mem_gap, gap)
            check(gap <= OBS_MEM_SLACK,
                  f"observability O1: memory/bytes_in_use/device0 "
                  f"{payload['memory/bytes_in_use/device0']} against "
                  f"memory_allocated() {allocated}")
            have = health_keys(payload)
            want_keys = {"off": set(), "cheap": tree_keys("grads"),
                         "full": tree_keys("grads", "optim_grads",
                                           "params")}[lv]
            check(have == want_keys, f"observability O1 {lv}: health keys "
                                     f"{sorted(have)}")
            for tree in ("grads", "optim_grads", "params"):
                if f"health/{tree}/nonfinite_count" in have:
                    check(payload[f"health/{tree}/nonfinite_count"] == 0.0
                          and payload[f"health/{tree}/first_nonfinite_leaf"]
                          == -1.0, f"observability O1 {lv}: {tree} "
                                   "reads non-finite")
            losses[lv].append(loss)
            if i:
                step_ms[lv].append(payload["time/step_ms"])
            payloads.append(payload)
            n += 1
    reporter.close()
    for lv in OBS_LEVELS[1:]:
        check(all(torch.equal(a, b) for a, b in zip(losses[lv],
                                                    losses["off"])),
              f"observability O1: {lv}'s losses differ from off's")
    digests = {lv: tree_digest(torch, (trainers[lv].params,
                                       trainers[lv].opt_state))
               for lv in OBS_LEVELS}
    check(len(set(digests.values())) == 1,
          f"observability O1: params and optimizer state differ across "
          f"the levels {digests}")
    lines = strict_jsonl(jsonl)
    check(len(lines) == n and [ln["step"] for ln in lines] == list(range(n)),
          f"observability O1: {len(lines)} JSONL lines for {n} reports")
    doc = strict_json(chrome)
    spans = [ev for ev in doc["traceEvents"] if ev["ph"] == "X"]
    check([ev["args"]["step"] for ev in spans] == list(range(n))
          and all(ev["name"] == "step" for ev in spans),
          f"observability O1: {len(spans)} spans for {n} timer stops")
    worst = max(abs(ev["dur"] / 1e3 - p["time/step_ms"]) / p["time/step_ms"]
                for ev, p in zip(spans, payloads))
    check(worst <= 1e-9, f"observability O1: a span's duration is "
                         f"{worst:.3g} off its timer's stop")
    first = losses["off"]
    print(f"observability O1: {n} reports, losses bit for bit at off, cheap "
          f"and full ({', '.join(f'{float(x):.6f}' for x in first)}), "
          f"params and optimizer state sha256 {digests['off'][:16]} at "
          f"each level; perf/mfu {min(mfus):.4f}-{max(mfus):.4f} against "
          f"costs.mfu of the reporter's own deltas, equal; "
          f"memory/bytes_in_use/device0 within {mem_gap} bytes of "
          f"memory_allocated() (limit {OBS_MEM_SLACK}); {len(lines)} strict "
          f"JSONL lines, {len(spans)} spans = the timer's stops (worst "
          f"{worst:.2g} relative); torch/compiles "
          f"{reg.snapshot().get('torch/compiles', 0.0):.0f} [{card}]")

    # each level's launches a step under the profiler (CUDA activity; a
    # probe trainer from the same state), against the bare step
    probe = gpt_trainer(torch, cfg, init_state, tokens, OBS_LR)

    def variant(level, collect):
        def fn():
            pol = None if level is None else health.HealthConfig(level=level)
            with health.activate(pol):
                if collect:
                    with ingraph.collecting():
                        probe()
                else:
                    probe()
        return fn

    variants = {"bare": variant(None, False),
                "off, no collector": variant("off", False),
                "collector, no policy": variant(None, True),
                "off": variant("off", True), "cheap": variant("cheap", True),
                "full": variant("full", True)}
    seen, busy = {}, {}
    for what, fn in variants.items():
        fn()
        torch.cuda.synchronize()
        rows, _, _ = profile_window(torch, fn, 1, f"observability {what}")
        seen[what] = round(sum(r[2] for r in rows))
        busy[what] = sum(r[1] for r in rows)
    check(seen["off, no collector"] == seen["bare"],
          f"observability O1: level off with no collector launches "
          f"{seen['off, no collector']}, the bare step {seen['bare']}")
    check(seen["off"] == seen["collector, no policy"],
          f"observability O1: level off in a collector launches "
          f"{seen['off']}, the collector with no policy "
          f"{seen['collector, no policy']}")
    for lv in OBS_LEVELS:
        ms = sorted(step_ms[lv])[len(step_ms[lv]) // 2]
        print(f"observability O1 {lv}: median step {ms:.3f} ms (Timers, "
              f"{OBS_STEPS} steps after a warm one), {seen[lv]} launches a "
              f"step ({seen[lv] - seen['off']:+d} against off), device busy "
              f"{busy[lv]:.3f} ms [{card}]")
    print(f"observability O1: launches a step: bare {seen['bare']}, off with "
          f"no collector {seen['off, no collector']}, a collector with no "
          f"policy {seen['collector, no policy']}, off in it {seen['off']}")

    # the budgets: FlopCounterMode over one probe step against bench.py's
    # analytic count, and the step's measured memory
    counted = costs.flops_budget(probe)
    budget = costs.memory_budget(probe)
    check(counted is not None and budget is not None,
          "observability O1: a budget came back None on the card")
    print(f"observability O1: flops_budget (FlopCounterMode) "
          f"{counted:.6g} FLOPs a step against the analytic {flops:.6g} "
          f"(6N + 12 L d seq a token, N {n_params}): ratio "
          f"{counted / flops:.4f}; FlopCounterMode sees aten's GEMMs, not "
          f"the ctypes flash kernels (B1-B3), whose attention FLOPs it "
          f"leaves out; memory_budget peak {budget['peak_hbm_bytes']} "
          f"bytes, temp {budget['temp_bytes']} [{card}]")
    for name in kern.LAUNCHES:
        launches.setdefault(name, 0)
    del trainers, probe
    torch.cuda.empty_cache()
    return launches


def obs_overflow(torch, kern, card: str, tmp: str, setup) -> dict:
    """O2: an overflow planted in ``OBS_PLANT`` at level cheap: with
    ``on_nonfinite="raise"`` the skip keeps every param, the
    ``NonFiniteError`` and the strict-JSON crash dump name the leaf; with
    ``"dump"`` and ``consecutive=2`` one overflow writes no dump and two in
    a row write one. Returns the launches."""
    from apex_tpu_torch.observability import (JSONLSink, MetricsRegistry,
                                              StepReporter, health, ingraph)

    cfg, init_state, tokens = setup
    step = gpt_trainer(torch, cfg, init_state, tokens, OBS_LR)
    inf = torch.tensor(float("inf"), device="cuda")

    def plant(params):
        # its gradient is inf in every element of the one leaf
        return params[OBS_PLANT].sum() * inf

    path = f"[{OBS_PLANT!r}]"
    numel = step.params[OBS_PLANT].numel()
    launches: dict = {}

    def run(reporter, level_cfg, k, planted):
        torch.cuda.synchronize()
        kern.reset_launches()
        with health.activate(level_cfg), ingraph.collecting() as col:
            loss, finite, grads = step(extra=plant if planted else None)
            metrics = col.freeze()
        del grads
        counts = dict(kern.LAUNCHES)
        check_gpt_counts(counts, f"observability O2 step {k}")
        add_counts(launches, counts)
        check(bool(finite) != planted, f"observability O2 step {k}: finite "
                                       f"{bool(finite)}, planted {planted}")
        return reporter.report(k, metrics=metrics)

    raising = health.HealthConfig(level="cheap", on_nonfinite="raise",
                                  dump_dir=f"{tmp}/o2_raise")
    with StepReporter([JSONLSink(f"{tmp}/o2.jsonl")],
                      registry=MetricsRegistry(),
                      hooks=[raising.reporter_hook()]) as reporter:
        run(reporter, raising, 0, False)
        before = tree_digest(torch, (step.params, step.opt_state))
        err = None
        try:
            run(reporter, raising, 1, True)
        except health.NonFiniteError as e:
            err = e
        check(err is not None, "observability O2: the planted overflow "
                               "raised no NonFiniteError")
        after = tree_digest(torch, (step.params, step.opt_state))
    check(before == after, "observability O2: the skipped step changed "
                           "the params or the optimizer state")
    check(err.dump.attribution == {"grads": path} and path in str(err),
          f"observability O2: NonFiniteError names {err.dump.attribution}"
          f" ({err}), not {path}")
    counted = err.dump.metrics["health/grads/nonfinite_count"]
    check(counted == numel, f"observability O2: {counted} non-finite, not "
                            f"{numel}")
    doc = strict_json(err.dump_path)
    check(doc["attribution"] == {"grads": path} and doc["step"] == 1,
          f"observability O2: the crash dump names {doc['attribution']}")

    dumping = health.HealthConfig(level="cheap", on_nonfinite="dump",
                                  consecutive=2, dump_dir=f"{tmp}/o2_dump")
    hook = dumping.reporter_hook()
    dumps = []
    with StepReporter([], registry=MetricsRegistry(),
                      hooks=[hook]) as reporter:
        for k, planted in enumerate((True, False, True, True), start=2):
            run(reporter, dumping, k, planted)
            dumps.append(len(hook.dumps))
    check(dumps == [0, 0, 0, 1], f"observability O2: dumps after each "
                                 f"step {dumps}, not [0, 0, 0, 1]")
    check(strict_json(hook.dumps[0])["attribution"] == {"grads": path},
          "observability O2: the consecutive dump names another leaf")
    # the stats of a leaf holding a NaN, an inf and a bf16 subnormal, on
    # the card: the largest magnitude NaN (the multi-tensor norm
    # propagates it), the counts exact
    probe = torch.tensor([1.0, float("nan"), -2.0, float("inf"), 1e-39,
                          0.0], device="cuda")
    stats = health.tensor_stats({"a": probe, "b": probe.to(torch.bfloat16),
                                 "c": probe[:1]})
    got = (stats.abs_max.tolist(), stats.finite_count.tolist(),
           stats.underflow_count.tolist(), float(stats.nonfinite_count()),
           float(stats.first_nonfinite_index()))
    check(math.isnan(got[0][0]) and math.isnan(got[0][1])
          and got[0][2] == 1.0 and got[1:] == ([4, 4, 1], [0, 1, 0], 4.0,
                                               0.0),
          f"observability O2: tensor_stats of a planted leaf on the card "
          f"{got}")
    print(f"observability O2: an overflow planted in {OBS_PLANT} ({numel} "
          f"elements, all inf): the skip kept params and optimizer state "
          f"(sha256 {before[:16]} before and after), NonFiniteError "
          f"'{str(err).split(';')[0]}', the dump names {doc['attribution']};"
          f" at consecutive 2 the dumps after each step {dumps} [{card}]")
    del step
    torch.cuda.empty_cache()
    return launches


# the kernels a trace names for each launch counter (each wrapper launches
# one such kernel; ln_bwd's column sums are a kernel of their own)
TRACE_KERNELS = {"flash_fwd": ("flash_fwd",),
                 "flash_bwd_dq": ("flash_bwd_dq",),
                 "flash_bwd_dkv": ("flash_bwd_dkv",),
                 "ln_fwd": ("ln_fwd_warp", "ln_fwd_block"),
                 "ln_bwd": ("ln_bwd_warp", "ln_bwd_block")}


def obs_profile(torch, kern, card: str, tmp: str, setup) -> dict:
    """O3: ``utils.timers.profile_trace`` around two steps at level cheap
    (primed, as every profiler window here); the Chrome trace's kernel
    events of B1-B3 and B7/B8 against the launch counter over the same
    steps. Returns the launches."""
    from apex_tpu_torch.observability import health, ingraph
    from apex_tpu_torch.utils.timers import profile_trace

    cfg, init_state, tokens = setup
    step = gpt_trainer(torch, cfg, init_state, tokens, OBS_LR)
    obs_step(torch, health, ingraph, step, "cheap")      # warm
    primer = torch.zeros(1, device="cuda")
    for attempt in range(PROFILE_TRIES):
        log_dir = f"{tmp}/o3_{attempt}"
        torch.cuda.synchronize()
        with profile_trace(log_dir):
            for _ in range(PROFILE_PRIMERS):
                primer.add_(1)
            torch.cuda.synchronize()
            kern.reset_launches()
            for _ in range(2):
                obs_step(torch, health, ingraph, step, "cheap")
            torch.cuda.synchronize()
            counts = dict(kern.LAUNCHES)
        with open(f"{log_dir}/trace.json") as f:
            events = json.load(f)["traceEvents"]
        names = [ev["name"] for ev in events if ev.get("cat") == "kernel"]
        traced = {k: sum(any(p in nm for p in pats) for nm in names)
                  for k, pats in TRACE_KERNELS.items()}
        want = {k: counts[k] for k in TRACE_KERNELS}
        if traced == want:
            break
        print(f"observability O3: trace {attempt + 1} of {PROFILE_TRIES} "
              f"holds {traced} of the counted {want}")
    check(traced == want, f"observability O3: {PROFILE_TRIES} traces "
                          f"miss kernels: {traced} against {want}")
    check_gpt_counts(counts, "observability O3 (two steps)", passes=2)
    print(f"observability O3: profile_trace's Chrome trace over two cheap "
          f"steps: {len(names)} kernel events; by name {traced}, equal to "
          f"the launch counter [{card}]")
    del step
    torch.cuda.empty_cache()
    return counts


def obs_hybrid(torch, kern, card: str, tmp: str, setup) -> dict:
    """O4: ``GPTHybridTrainer`` at tp = pp = dp = 1 on a world-1 NCCL group,
    ``TrainConfig(health_level="full")`` at ``OBS_HYBRID_LAYERS`` layers of
    GPT-small's widths: the params' and the synced grads' replica
    divergence 0.0, and the losses the bits of the same trainer at off.
    Returns the launches."""
    import torch.distributed as dist
    from apex_tpu_torch.training import GPTHybridTrainer
    from apex_tpu_torch.transformer import parallel_state

    _, _, tokens = setup
    batch = tokens[None]                      # (M 1, 8, 1024)
    launches: dict = {}
    losses, payloads = {}, {}
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl",
                            rank=0, world_size=1)
    try:
        for level in ("off", "full"):
            cfg = dataclasses.replace(elastic_config(OBS_HYBRID_LAYERS),
                                      health_level=level)
            trainer = GPTHybridTrainer(cfg, cfg.initialize_mesh(),
                                       init_scale=PP_SCALE, device="cuda")
            state = trainer.init_state(torch.Generator().manual_seed(0))
            losses[level], payloads[level] = [], []
            for i in range(OBS_HYBRID_STEPS):
                torch.cuda.synchronize()
                kern.reset_launches()
                loss, *state, metrics = trainer.train_step_with_metrics(
                    *state, batch, batch)
                torch.cuda.synchronize()
                counts = dict(kern.LAUNCHES)
                check_elastic_counts(counts, OBS_HYBRID_LAYERS, 1,
                                     f"observability O4 {level} step {i}")
                add_counts(launches, counts)
                losses[level].append(loss.detach().clone())
                payloads[level].append(metrics.as_floats())
            del trainer, state
            parallel_state.destroy_model_parallel()
    finally:
        parallel_state.destroy_model_parallel()
        dist.destroy_process_group()
    check(all(torch.equal(a, b) for a, b in zip(losses["full"],
                                                losses["off"])),
          "observability O4: the losses at full differ from off's")
    for p in payloads["off"]:
        check(not health_keys(p), "observability O4: off recorded health/*")
    for p in payloads["full"]:
        check(p["health/params/replica_divergence"] == 0.0
              and p["health/ddp_grads/replica_divergence"] == 0.0,
              f"observability O4: replica divergence "
              f"{p['health/params/replica_divergence']} (params), "
              f"{p['health/ddp_grads/replica_divergence']} (ddp grads)")
        check(tree_keys("grads", "optim_grads", "params")
              <= health_keys(p), "observability O4: a tree's keys missing")
    print(f"observability O4: GPTHybridTrainer (tp = pp = dp = 1, NCCL at "
          f"world 1, {OBS_HYBRID_LAYERS} layers of GPT-small's widths) at "
          f"health level full: health/params/replica_divergence 0.0 and "
          f"health/ddp_grads/replica_divergence 0.0 at each of "
          f"{OBS_HYBRID_STEPS} steps, {len(health_keys(payloads['full'][0]))}"
          f" health keys; losses bit for bit off's "
          f"({', '.join(f'{float(x):.6f}' for x in losses['off'])}) "
          f"[{card}]")
    torch.cuda.empty_cache()
    return launches


def observability(torch, kern, card: str) -> list:
    """The observability group: O1-O4 (the module docstring), each timed.
    Returns ``(what, launches)`` of each leg, in order."""
    import tempfile

    paths = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_obs_") as tmp:
        setup = gpt_small_setup(torch)
        t = [time.perf_counter()]
        for what, leg in (
                (f"the telemetry stack's GPT-small steps (O1: 3 levels x "
                 f"{1 + OBS_STEPS} steps)",
                 obs_training),
                ("the planted overflows (O2: 6 steps)", obs_overflow),
                ("the profiled steps (O3: the 2 of the trace read)",
                 obs_profile),
                (f"the hybrid trainer at off and full (O4: 2 x "
                 f"{OBS_HYBRID_STEPS} steps, {OBS_HYBRID_LAYERS} layers)",
                 obs_hybrid)):
            paths.append((what, leg(torch, kern, card, tmp, setup)))
            t.append(time.perf_counter())
        print("observability: wall seconds " + ", ".join(
            f"O{i + 1} {b - a:.1f}" for i, (a, b) in enumerate(zip(t, t[1:])))
            + f"; the group {t[-1] - t[0]:.1f}")
    return paths


# the groups of phases ``python3 chip_smoke.py [group ...]`` runs (all of
# them with no argument); the build and the kernel checks run in every
# call
GROUPS = ("serving", "serving_host", "training", "models", "dist",
          "elastic", "observability")


def dbias_row_alone(torch, fa, kern, card: str) -> dict:
    """B6's row of the kernels line when ``long_context`` (the training
    group) does not run: the four flash kernels against their plain
    versions at the long-context shape and their times there, as
    ``long_context`` takes them first."""
    q, k, v, dy, ids, slopes0 = long_inputs(torch)
    errs = check_long_kernels(torch, fa, kern, card, q, k, v, dy, ids,
                              slopes0)
    row, _ = time_long_kernels(torch, fa, kern, card, q, k, v, dy, ids,
                               slopes0)
    row["max_abs_err"] = max(errs["flash_dbias"], errs["flash_dbias_fold"])
    del q, k, v, dy, ids
    torch.cuda.empty_cache()
    return row


def parse_groups(argv) -> tuple:
    """The groups named on the command line (all with none); an unknown
    name exits non-zero before anything runs."""
    unknown = [a for a in argv if a not in GROUPS]
    if unknown:
        print(f"chip_smoke: unknown group(s) {unknown}; the groups are "
              f"{', '.join(GROUPS)}", file=sys.stderr)
        sys.exit(2)
    return tuple(g for g in GROUPS if g in argv) if argv else GROUPS


def main(argv=None) -> None:
    groups = parse_groups(sys.argv[1:] if argv is None else argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        sys.exit(2)
    from apex_tpu_torch import _kernels as kern
    fa = importlib.import_module("apex_tpu_torch.ops.flash_attention")
    cache_mod = importlib.import_module("apex_tpu_torch.serving.cache")
    ln = importlib.import_module(
        "apex_tpu_torch.normalization.fused_layer_norm")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"device: {card}")
    print(f"groups: {', '.join(groups)}")
    # wall seconds a group of phases takes, printed before the last lines
    start = last = time.perf_counter()
    seconds = {}

    def lap(name: str) -> None:
        nonlocal last
        now = time.perf_counter()
        seconds[name] = now - last
        last = now

    _, build_s = kern.build()
    secs = re.findall(r"^--- (\S+) \(([\d.]+) s\)", kern.build_log(), re.M)
    print(f"build: kernels built in {build_s:.1f} s "
          f"({', '.join(kern.SOURCES)}); nvcc a source, all started "
          "together: " + (", ".join(f"{src} {t} s" for src, t in secs)
                          or "not in this build's log"))
    mma_resources(kern)
    decode_resources(kern)
    lap("build")

    print(f"kernel vs plain: limits (atol, rtol, relative norm) bf16 "
          f"{BF16_TOL}, fp32 {FP32_TOL}, flash_fwd's bf16 atol plus "
          f"{FWD_P_ROUNDING:.4g} x sum_j p_j |v_j|; lse {TOL_LSE}")
    prefill_row = check_flash(torch, fa, kern, card)
    fwd_row, dq_row, dkv_row = check_flash_train(torch, fa, kern, card)
    fwd_row["max_abs_err"] = max(fwd_row["max_abs_err"],
                                 prefill_row["max_abs_err"])
    rows = [fwd_row, check_decode(torch, fa, cache_mod, kern, card), dq_row,
            dkv_row, check_paged(torch, fa, cache_mod, kern, card)]
    check_head_dims(torch, fa, cache_mod, kern)
    check_flash_head_dims(torch, fa, kern, card)
    flash_dim_timings(torch, fa, kern, card)
    rows += check_layer_norm(torch, ln, kern, card)
    check_flash_bias(torch, fa, kern, card)
    check_flash_segments(torch, fa, kern, card)
    check_flash_dq(torch, fa, kern, card)
    check_flash_dbias(torch, fa, kern, card)
    lap("kernel checks")
    # (what ran, its launch counts), in the order the phases ran
    paths = []
    if "serving" in groups:
        serving, dense_times = serve(torch, kern, card)
        paths.append(("serving", serving))
        paths.append(("small serving (d 16)", serve_small(torch, kern,
                                                           card)))
        paths.append(("paged serving", serve_paged(torch, kern, card,
                                                   dense_times)))
        spec, spec_cursors = serve_spec(torch, kern, card, paged=False)
        paths.append(("speculative serving (plain and speculative legs)",
                      spec))
        paged_spec, paged_spec_cursors = serve_spec(torch, kern, card,
                                                    paged=True)
        paths.append(("paged speculative serving", paged_spec))
        check_verify_kernels(torch, fa, cache_mod, kern, card, spec_cursors,
                             paged_spec_cursors)
        lap("serving")
    if "serving_host" in groups:
        model = spec_model(torch, torch.bfloat16)
        paths.append(("serving under the SLO and the burst",
                      serve_goodput(torch, kern, card, model)))
        paths.append(("the chaos runs", serve_chaos(torch, kern, card,
                                                    model)))
        host_cost_off(torch, card, model)
        del model
        torch.cuda.empty_cache()
        lap("serving host layer")
    dbias_row = None
    if "training" in groups:
        paths.append((f"training ({TRAIN_STEPS} steps, then one with "
                      "dropout)", train(torch, kern, card)))
        paths.append((f"small training (d 8, {TRAIN_SMALL_STEPS} steps)",
                      train_small(torch, kern, card)))
        paths.append((f"the remat legs ({len(REMAT_LEGS)} x {REMAT_STEPS} "
                      "steps, then 3 with dropout)",
                      train_remat(torch, kern, card)))
        torch.cuda.empty_cache()
        lap("GPT training")
        paths.append((f"TrainConfig training ({CONFIG_STEPS} steps)",
                      train_config(torch, kern, card)))
        lap("train_config")
        paths.append((f"ResNet-50 training (bench_headline, "
                      f"{HEADLINE_WARMUP + HEADLINE_STEPS} steps)",
                      train_resnet(torch, kern, card)))
        lap("train_resnet")
        paths.append((f"BERT training ({BERT_STEPS} steps)",
                      train_bert(torch, kern, card)))
        lap("train_bert")
        long, dbias_row = long_context(torch, fa, kern, card)
        paths.append((f"long-context training ({LONG_STEPS} steps)", long))
        lap("long_context")
        paths.append((f"BERT with LAMB ({LAMB_STEPS} steps)",
                      train_lamb(torch, kern, card)))
        lap("train_lamb")
        paths.append(("the optimizer legs' GPT pass",
                      optim_legs(torch, kern, card)))
        lap("optim_legs")
    if "models" in groups:
        paths.append(("the Transformer-big block (one forward and "
                      "backward)", transformer_ops(torch, fa, kern, card)))
        lap("transformer_ops")
        paths.append(("the RNN-T steps", rnnt(torch, kern, card)))
        lap("rnnt")
        paths.append(("the RetinaNet head", retinanet_head(torch, kern,
                                                           card)))
        lap("retinanet_head")
        paths.append((f"GPT-small under ASP ({ASP_STEPS} steps and an "
                      "overflow step)", asp_gpt(torch, kern, card)))
        lap("asp_gpt")
        paths.append(("the tp=1 layer and logits", tp1_gpt(torch, kern,
                                                           card)))
        lap("tp1_gpt")
    if "dist" in groups:
        # data parallelism: NCCL at world 1 in this process (the kernels
        # are built, so the two ranks of dist_ranks load them), then two
        # ranks
        import shutil
        import tempfile
        import torch.distributed as dist
        from apex_tpu_torch.transformer import parallel_state
        torch.cuda.set_device(0)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as store:
            dist.init_process_group("nccl",
                                    init_method=f"file://{store}/nccl",
                                    rank=0, world_size=1)
            parallel_state.initialize_model_parallel()
            paths.append((f"GPT-small under DDP at world 1 ({DDP_STEPS} + 2 "
                          "profiled steps, the accumulation window)",
                          ddp_gpt(torch, kern, card)))
            lap("ddp_gpt")
            zero, zero_losses, zero_bytes, zero_total = zero_gpt(torch,
                                                                 kern, card)
            paths.append((f"under ZeRO at world 1 ({ZERO_STEPS} steps)",
                          zero))
            lap("zero_gpt")
            parallel_state.destroy_model_parallel()
            dist.destroy_process_group()
        torch.cuda.empty_cache()
        # one pool of two ranks for the two-rank legs (its processes start
        # once), then the hybrid trainer's four
        from apex_tpu_torch.parallel._spawn import RankPool
        t0 = time.perf_counter()
        pair = RankPool(2, backend="gloo", device="cuda",
                        pg_timeout=DIST_TIMEOUT)
        print(f"dist: a pool of two ranks on the card over gloo started in "
              f"{time.perf_counter() - t0:.1f} s, shared by dist_ranks, "
              f"tp_gpt, pp_gpt, cp_attention and ep_spatial")
        root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
        try:
            paths.append(("the two ranks' DDP, ZeRO and overflow steps",
                          dist_ranks(torch, kern, card, zero_losses,
                                     zero_bytes, zero_total, pool=pair)))
            lap("dist_ranks")
            paths.append((f"the two tensor ranks' steps ({len(TP_LEGS)} "
                          f"legs x {TP_STEPS} steps, then a skipped one)",
                          tp_gpt(torch, fa, kern, card, pool=pair)))
            lap("tp_gpt")
            paths.append((f"the two pipeline ranks' schedules and steps "
                          f"({PP_STEPS} and a skipped one)",
                          pp_gpt(torch, kern, card, pool=pair)))
            lap("pp_gpt")
            cp_ranks, ep_ranks, zero_ckpt = dist_cp_ep(
                torch, kern, card, f"{root}/zero", pool=pair)
            paths.append(("the two context ranks' Ulysses calls (2 a "
                          "rank)", cp_ranks))
            paths.append((f"the two ZeRO ranks' steps before their "
                          f"checkpoint ({ZERO_CKPT_STEPS} a rank)",
                          ep_ranks))
            lap("cp_attention + ep_spatial")
            pair.close()
            torch.cuda.empty_cache()
            paths.append((f"the hybrid trainer's four ranks "
                          f"({HYBRID_STEPS} steps and a skipped one)",
                          hybrid_gpt(torch, kern, card)))
            lap("hybrid_gpt")
            paths.append(("the resumed GPT-small steps and the watcher's "
                          "engine", checkpoint_resume(torch, kern, card,
                                                      root, zero_ckpt)))
            lap("checkpoint_resume")
        finally:
            pair.close()
            shutil.rmtree(root, ignore_errors=True)
    if "elastic" in groups:
        paths.append((f"the elastic runs (E1: {ELASTIC_STEPS} straight, "
                      f"{ELASTIC_PREEMPT_AT} preempted + "
                      f"{ELASTIC_STEPS - ELASTIC_PREEMPT_AT} resumed, 3 "
                      "drained; E2: the survivor's steps and this "
                      "process's two replays)", elastic(torch, kern, card)))
        lap("elastic")
    if "observability" in groups:
        paths += observability(torch, kern, card)
        lap("observability")
    if dbias_row is None:
        dbias_row = dbias_row_alone(torch, fa, kern, card)
        lap("B6 row")
    rows.append(dbias_row)
    print("launches on the main paths: " + ", ".join(
        f"{what} {counts}" for what, counts in paths))
    for row in rows:
        # B6 runs as the fold on the bf16 paths, as flash_dbias elsewhere
        names = ((row["name"], "flash_dbias_fold")
                 if row["name"] == "flash_dbias" else (row["name"],))
        row["launches"] = sum(counts.get(name, 0) for _, counts in paths
                              for name in names)
        row["body"] = BODY.get(row["name"], "SIMT")
        if row["name"] in ("decode_attention", "paged_decode_attention"):
            row["head_dims"] = (f"d % 8 == 0, {DECODE_DIMS[0]} to "
                                f"{DECODE_DIMS[-1]}")
        if row["name"] in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            row["head_dims"] = FLASH_HEAD_DIMS
    print(f"profiler: {PROFILER_STATS['windows']} windows read, "
          f"{PROFILER_STATS['retaken']} taken again, at most "
          f"{PROFILER_STATS['primers_lost']} of {PROFILE_PRIMERS} primer "
          "records lost in one")
    print("wall seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items())
        + f"; all {time.perf_counter() - start:.1f} s")
    keys = ("name", "route", "body", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "head_dims")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == [E2_WORKER_FLAG]:
        elastic_worker()
    else:
        main()
