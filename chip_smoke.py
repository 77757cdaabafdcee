#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (mxnet_tpu_torch) on one card.

    python3 chip_smoke.py [--report PATH]

Phases; any failure raises and the script exits non-zero:

1. The card: torch version, device name, and its name and power limit
   from nvidia-smi. TF32 is switched off for convolutions and matmuls so
   every comparison below is in full f32.
2. Build every kernel from ``mxnet_tpu_torch/csrc`` (one nvcc per
   source, all started together) and print the build time, ptxas's
   registers, spills and wgmma notes, and the HGMMA (wgmma) count in
   ``cuobjdump -sass`` of the ``flash_attn`` and ``flash_fwd`` libraries:
   0 fails (the flash tile must run on tensor cores).
3. Each kernel against its plain torch version at every distinct shape
   of the 49 fused ResNet-50 sites (33 ``bn_act`` + 16 ``bn_act_res``),
   at batch 1 and 32, f32 and bf16, with and without the residual.
   f32 within atol/rtol 1e-5 (nvcc may contract the multiply-add into an
   FMA where torch rounds twice); bf16 within one bf16 ulp of the plain
   result plus that same 1e-5 (near zero, where a sum cancels, the FMA's
   f32 difference is more than a bf16 ulp); every NaN and infinity of
   the plain result must be the kernel's too. Then B1's index paths
   (``B1_EDGE_SHAPES``: rows of odd length, rows a multiple of a vector,
   rows shorter than a vector, one channel, element counts no multiple
   of 8), both dtypes, forms and activations, again with NaN, +-inf and
   -0.0 planted in x, and with x and r at the storage offsets
   ``B1_EDGE_OFFSETS``; one launch captured in a CUDA graph and
   replayed, bitwise the eager launch. Then device times at batch 32
   (median of 20 CUDA-event pairs, L2 flushed before every launch by
   writing 96 MB, and again by reading it, which leaves L2 clean; host
   enqueue hidden) beside the bound, the larger of the bytes moved over
   3.35 TB/s and the f32 flops over 67 TFLOP/s, and beside torch's copy
   of x into y (a yardstick, not the same function; phases 12 and 20 time
   their B1 classes the same way); an empty kernel's time in both flush
   modes, the least any launch reads; and the host time of one launch
   through the wrapper.
4. The main path: ResNet-50 (224x224, 1000 classes, weights drawn from
   numpy RandomState(0) as bench.py's serving leg draws them) exported
   with a dynamic batch and served by ``Server`` with buckets (1, 8, 32):
   8 single-image requests, one batch of 8 and one of 32, submitted
   concurrently, then one image and one batch of 8 alone, so that every
   bucket serves. Launch counts are zeroed just before and read just
   after: each executed forward must launch 49 kernels (33 + 16), with
   no tier fallback. Every answer is checked (shape, finite, rows sum to
   1) and held against the same artifact served at kernel_tier=off on
   the card (f32, 1e-5 abs). Then p50/p99 latency and images/s per
   bucket (closed loop, 20 requests each); the eager forward at batch 1
   and 32, tier off/auto/auto/off; a torch.profiler pass per tier and
   batch (device busy share, bn_act's device time, top kernels); and
   last one image on the CPU against the card's answer (1e-5 abs).
5. The decode kernels against their plain torch versions, f32 and bf16,
   at the generate path's shapes: ``take_rows`` on a (16400, 768) table
   by (16, 1024) ids, out-of-range ones included (bitwise);
   ``flash_attn`` at prefill's (16, 12, 128, 64) causal and at T = 100
   with head dims 64, 32 and 128;
   ``flash_attn_paged`` for a decode step (16 slots, W = 1, positions 0,
   page boundaries and a spread up to 1023), for prompt chunks (one
   slot, W = 128, at positions 0 and 256) and for the speculative
   verifier (16 slots, W = 5). f32 within atol 2e-5, rtol
   1e-4 (FMA contraction and another summation order); bf16 within one
   bf16 ulp plus 1e-3. ``flash_attn_paged`` also on the non-finite
   cases of ``tests/paged_nonfinite.py`` (NaN or inf planted in V or K
   at masked positions, a repeated trailing page, a position masked for
   row 0 only, and a finite control) at the decode geometry and a chunk
   at position 250, f32 and bf16: the plain version's NaN and inf masks
   must be the contract's, the kernel's must equal them exactly, and
   the finite values are held to the tolerance above. Then each
   kernel's f32 time beside its plain version's, the library call's
   where one exists (``index_select`` of pre-clipped ids;
   ``scaled_dot_product_attention``, its device kernel named from the
   profiler) and the bound, the larger of bytes over 3.35 TB/s and
   flops over 67 TFLOP/s; for ``flash_attn`` the flops count three
   times over at 495 TFLOP/s (the TF32 tensor cores and the kernel's
   three split products), the f32 CUDA-core figure printed beside it.
   ``flash_attn_paged`` is timed at the decode step with 64 distinct
   pages a slot and in the serving layout (unused entries page 0), and
   at chunk@256, and the longest slot alone (position 1023, 12 CTAs of
   64 pages each), and at the verifier's W = 5 in both layouts; its bound counts the contract's work (visible K and V,
   and V of every listed row, each row once), the visible rows' bound
   printed beside it, and each time is also taken after a flush that
   leaves L2 clean.
6. The generate path: a decoder at GPT-2 small's widths (vocab 50257,
   dim 768, 12 heads, 12 layers, context 1024; ``init_params(spec,
   seed=0)``) exported with chunked prefill and served by ``Server`` in
   generate mode: 24 requests at once into 16 slots (22 prompts of 8-128
   tokens, 2 of 300-400 through ``chunk_prefill``, 32-96 new tokens,
   every third sampled at temperature 0.8). Counts are zeroed just
   before the server is built (its warmup included) and read after it
   closes: ``flash_attn`` must launch 12 times per prefill run,
   ``flash_attn_paged`` 12 times per decode step and per chunk,
   ``take_rows`` never at this geometry, with no tier fallback. Every
   request must come back whole. Its tokens are held against the same
   artifact at kernel_tier=off and, for 4 greedy requests, against
   ``reference_generate``: equal up to the first position where the
   tier-off logits' top-1/top-2 margin (of Gumbel noise + logits / t
   when sampling) is below 1e-4; there the two tiers' logits (a
   teacher-forced replay through ``chunk_prefill``) must agree within
   1e-4, and no more than 1 sequence in 8 may stop early. Then TTFT and
   TPOT p50/p99, generated tokens/s, the wall time of a decode step and
   its device busy share (torch.profiler).
   Then the speculative path: the same weights exported with their int8
   draft (``quantize_decoder_params``) and ``speculate_k=4``, as
   bench.py's decode leg (the int8 weight bytes against f32's and
   ``suggest_speculation_depth``'s pick on the H100's rates printed),
   served by ``Server(..., draft="on")`` to the same 24 requests.
   Counts are zeroed just before the server is built and read after it
   closes: ``flash_attn`` 12 launches per prefill run,
   ``flash_attn_paged`` 12 x (k + 1) per speculative step and 12 per
   chunk (the verifier's chunks of the long prompts, the draft's chunks
   of every prompt, and the warmup's decode step, chunk, draft chunk
   and speculative step), ``take_rows`` none, no tier fallback. Every
   request's tokens are held against the plain server's (tier off and
   tier auto) by the near-tie rule above; some greedy request must
   accept a draft token; ``accepted_tokens_per_step`` and
   ``draft_acceptance_rate`` printed per request. One speculative step
   from 16 slots prefilled with the first 16 prompts, at tier auto and
   at tier off: the draft's proposals, the verifier's tokens and
   ``n_accept`` equal up to the first row whose draft or verifier
   top-1/top-2 margin (tier off, as above) is below 1e-4, no more than
   1 slot in 8 stopping early. Then TTFT, TPOT and tokens/s with
   speculation on beside the plain path's, and the speculative step's
   wall time against its device time (torch.profiler). B4 at the
   verifier's shape (16 slots, W = 5, positions up to 1019) is checked
   and timed in phase 5 like the decode step.
7. The training kernels against their plain versions on the card, f32
   and bf16: ``scale_bias_act`` at the MLP's (8192, 3072) and a ragged
   (1000, 3000), ReLU, GeLU and identity, with and without the scale,
   forward and the gradients of x, scale and bias; ``flash_fwd`` at
   (8, 12, 1024, 64) causal and not, causal cross-length (tq 100, tk 60:
   the fully masked rows must be exactly 0), a ragged T = 100, head dim
   32 at T = 100 and head dim 128 at T = 256 (not causal), forward and
   the q, k, v gradients, against ``blockwise_attention``;
   ``flash_attn`` at (8, 12, 1024, 64) causal and ``take_rows`` on the
   (50257, 768) token table by (8, 1024) ids, forward and the new
   backward. Forwards within the tolerances of phase 5 (the gather
   bitwise); gradients f32 within atol 2e-5, rtol 1e-4, bf16 within a
   relative L2 error of one bf16 ulp (a bf16 gradient sums up to 1024
   terms rounded in other places); the row gather's scatter-add bitwise
   (its cotangents are quarters, exact in any order). Then the f32
   times of B5, B7, and of B3 and B2 at these shapes, beside plain,
   library and bound (B3 and B7 bounded as in phase 5, both ways).
8. The training path: the GPT of ``examples/train_transformer_lm.py``
   at GPT-2 small's widths (vocab 50257, dim 768, 12 heads, 12 layers,
   T 1024; Xavier from seed 0) trained by ``Module.fit`` with Adam (lr
   3e-4, wd 0.01) and kvstore ``tpu_sync`` for 8 steps of batch 8 on the
   lag-17 copy task, at tier auto and from the same weights at tier off.
   Counts are zeroed just before each fit and read just after: at auto
   every step launches ``flash_attn`` 12, ``scale_bias_act`` 12,
   ``take_rows`` 1 and ``flash_fwd`` 0 times; at off ``flash_fwd`` 12
   and the others 0; no tier fallback. The tiers' losses agree within
   1e-4 relative and step 1's gradients within 1e-3 of each tensor's
   largest magnitude; every loss is finite; on one batch repeated six
   times the loss at step 6 is below step 1's. Then the step's numbers:
   wall time p50 and tokens/s, forward, backward and update times (CUDA
   events), a torch.profiler pass (device busy share, top kernels, B3's
   recomputed backward), the peak memory and model FLOPs over the f32
   peak. Last the model cut to 2 layers at T 128, batch 2, on the card
   against the CPU: each of two steps' gradients within 1e-3 of each
   tensor's largest magnitude of the CPU's taking the card's ReLU
   decisions (at most 4 ReLU inputs of opposite sign between the two,
   each within 1e-4 of its tensor's largest magnitude from 0; the plain
   CPU's difference printed), and after 2 SGD-momentum steps by ``Module.fit``
   (lr 1e-4) losses within 1e-5 relative and parameters within 1e-4;
   the same steps at lr 0.01 are printed beside two CPU runs that
   differ only in thread count.
9. The Gluon path: the GPT of ``examples/train_transformer_lm.py``,
   class for class (``tests/gluon_gpt.py``), built on the port's Gluon
   at the widths of phase 8 (Xavier seed 0, ``pos_weight``
   Normal(0.02)) and trained as the example trains it:
   ``autograd.record()`` -> ``loss.backward()`` -> ``trainer.step(1)``,
   ``SoftmaxCrossEntropyLoss`` on ``logits[:, 17:]``, Adam (lr 3e-4, wd
   0.01), hybridized, on phase 8's batches: 8 steps at tier auto (the
   main path; counts zeroed just before, read just after), 8 at tier off
   and 5 un-hybridized at auto, each from the same weights. Every step's
   launches are counted: at auto 12 ``flash_attn``, 1 ``take_rows``, no
   ``scale_bias_act`` (Gluon never fuses bias and ReLU, as in the JAX
   package) and no ``flash_fwd``; at off 12 ``flash_fwd`` and nothing
   else; no tier fallback. Tier off and the eager run are held against
   the hybridized auto run: losses within 1e-4 relative, step 1's
   gradients within 1e-3 of each tensor's largest magnitude (the head's
   printed). One batch six times: the loss falls. Then the step p50
   (steps 2-N) of each run and tokens/s beside ``Module.fit``'s p50 from
   phase 8, one step's forward (with the loss), backward and update
   (CUDA events), a torch.profiler pass (busy share, launches, B3's
   recomputed backward, top kernels) and the peak memory. Last the model
   cut to 2 layers at T 128, batch 2, on the card against the CPU from
   the same weights: step 1's gradients within 1e-3 of each tensor's
   largest magnitude of the CPU's taking the card's ReLU decisions, at
   most 4 ReLU inputs of opposite sign, each within 1e-4 of its
   tensor's largest magnitude from 0, and after 2 SGD-momentum steps
   (lr 1e-4) losses within 1e-5 relative and parameters within 1e-4.
10. The int8 kernel ``int8_dequant`` (B6) against its plain version on
   the card at every distinct (accumulator shape, activation) of the 54
   quantized ResNet-50 sites, batch 1 and 32, in the per-column form the
   path uses ((N*OH*OW, O) from the GEMM; (N, 1000) for the FC) and, at
   the conv sites, the per-row form at the same shapes ((N*O, OH*OW),
   O coefficients), and at a ragged (1001, 999) in both: within one f32
   ulp of the larger of |acc * sc| and |y| (the kernel's FMA and the
   plain version's f64 sum each round once), the bitwise share printed.
   Then the f32 times at batch 32 (median of 20 CUDA-event pairs, L2
   flushed) per site class, summed over the 54 sites, beside the plain
   version and the bound (8 bytes an element over 3.35 TB/s). Then the
   int8 product: ``torch._int_mm`` through the port's padding helper on
   the card against the CPU at every site's shape (batch 1), bitwise.
11. The int8 serving path: the same ResNet-50 weights calibrated on the
   card over 4 batches of 8 synthetic images (RandomState(2)), exported
   by ``quant.export_quantized`` as a format-4 artifact (54 sites, none
   skipped; int8 weight payload at most 0.3x the f32 one), and served by
   ``Server(f32, quantized=int8)`` with buckets (1, 8, 32): 16 requests
   (6 images, a batch of 8 and one of 32 per dtype) at once, then an
   image and a batch of 8 per dtype alone. Counts are zeroed just before
   the server is built and read after: each int8 forward launches
   ``int8_dequant`` 54 times (33 ReLU, 21 identity, per-column form) and
   each f32 forward ``bn_act`` 49 times; no tier fallback; both dtypes
   serve every bucket. Every answer is a softmax row; int8 answers match
   the int8 artifact at kernel_tier=off on the card and, for one image,
   on the CPU within 1e-5 (integer parts exact, each epilogue rounds
   once: only an f32 value on an int8 rounding tie can move a quantized
   input by one step); int8 against f32: top-1 agreement and max |dp|
   printed, and every row whose f32 top-1/top-2 margin exceeds twice its
   |dp| must keep its class. Then per dtype p50/p99 latency and images/s
   per bucket, the eager forward at batch 1 and 32 (int8, f32, f32,
   int8), and a torch.profiler pass of the int8 forward at batch 1 and
   32: device busy share, and the device time of B6, of ``_int_mm``, of
   quantize + im2col and of the rest.
12. B1 (``bn_act``) against its plain version at every site class of
   the bf16 training forward at batch 128 (tolerance of phase 3), then
   its bf16 times per class (both flushes, as phase 3) and summed over
   the 49 sites, beside the bound (bf16 bytes over 3.35 TB/s: half of
   f32's 94.7 MB an image).
13. The ResNet-50 training path, as bench.py's fit leg runs it: ResNet-50
   v1 (224x224, 1000 classes, weights from ``Xavier(factor_type="in",
   magnitude=2)``, seed 0) trained by ``Module.fit`` with SGD (lr 0.05,
   momentum 0.9, ``multi_precision``: bf16 compute over f32 masters),
   kvstore ``tpu_sync``, ``steps_per_dispatch=1``, no metric, on one
   synthetic batch (randn images, randint(0, 1000) labels from
   RandomState(0)) repeated: 10 steps of batch 128 at tier auto (the
   main path; counts zeroed just before, read just after: 49 B1 launches
   a step, 33 + 16, no fallback) and 10 at tier off (none), then 8 steps
   of f32 at batch 32 at tier auto (49 a step). Every step's master
   weights must stay f32, the moving statistics f32 and moved, the
   losses finite and the lowest after the first update below the first.
   The tiers' step-1 losses within 5e-3 relative and every step's within
   5e-2 (the JAX package's own bf16 bound; what tier off parts from
   itself on images moved by half a bf16 ulp is printed beside it); the
   first-step gradients of the head (``fc1``) within twice their
   bf16-vs-f32 error. Then the step's numbers per dtype:
   wall p50 over steps 2-N, images/s, model FLOPs over the dtype's dense
   peak, peak memory, forward/backward/update (CUDA events), busy
   share, B1's device time, the batch-statistics and recomputed
   backward ranges and the top kernels (profiler). Last, ResNet-50 at
   batch 2 on the card against the CPU, f32 and bf16: outputs and
   gradients held as ``resnet_card_vs_cpu`` states (the backward's
   rounding sensitivity at these weights bounds what can be held), the
   ReLU sign flips counted.
14. Gluon image training. First the random key chain: after
   ``random.seed(0)`` uniform, randint, Dropout masks (eager and in a
   hybridized block), shuffles and multinomial draws on the card equal
   the same draws on the CPU bitwise, normal and exponential draws
   within 4 f32 ulp. Then the main path: ResNet-50 v1 from
   ``gluon.model_zoo.vision`` (224x224, 1000 classes, Xavier(in, 2) from
   seed 0), hybridized, trained in f32 through Gluon as a user trains
   it: 320 uint8 HWC images and labels from numpy RandomState(0) in an
   ``ArrayDataset`` whose images pass RandomFlipLeftRight, ToTensor and
   Normalize, a shuffled ``DataLoader`` (batch 32, last batch
   discarded), ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` ->
   ``backward()`` -> ``Trainer.step(32)`` (SGD lr 0.05, momentum 0.9, wd
   1e-4), 10 steps. Counts are zeroed just before and read just after:
   every step launches no kernel and the tier dispatches nothing (Gluon
   fuses no BatchNorm+ReLU, in either package). Every loss finite, every
   parameter f32; on one batch repeated six times the loss falls. Then
   the step p50 over steps 2-10 and images/s, model FLOPs (24.5 GFLOP an
   image) over the f32 peak, the DataLoader's host time a batch and the
   loop's images/s with it, forward/backward/update (CUDA events), the
   busy share, device time by kind and top kernels (profiler), the peak
   memory, beside phase 13's f32 batch-32 ``Module.fit`` step. Then
   ``save_parameters`` and ``resnet50_v1().load_parameters(path,
   ctx=gpu(0))``: inference outputs bitwise equal, and the file's bytes
   those of a save of the same values from CPU tensors. Then the
   DataLoader with ``num_workers=2`` (forked workers batchify to numpy,
   the main process places the batch on the card): bitwise the in-process
   batches. Then ``resnet18_v1(thumbnail=True, classes=10)`` at 32x32,
   batch 2, on the card against the CPU with phase 9's limits, the CPU
   differentiating through the card's ReLU decisions. Last B1's op
   surface ``_contrib_FusedBNAct`` at the 9 site classes of ResNet-50,
   f32 at batch 32 and bf16 at batch 128, in training and inference,
   eagerly (``nd.contrib``) and in a hybridized block (``F.contrib``):
   one B1 launch a call (counts zeroed just before, read after), no
   fallback; outputs and moving statistics within phase 3's tolerances
   of the op's plain version, gradients within them of the plain vjp;
   the eager op's inference time summed over the 49 sites beside
   phase 3's and phase 12's kernel totals.
15. Grouped dispatch. The main path: ResNet-50 v1 set up as in phase
   13 (Xavier(in, 2) seed 0, SGD lr 0.05, momentum 0.9,
   ``multi_precision``, ``tpu_sync``, one synthetic batch of 128
   repeated) trained by ``Module.fit(steps_per_dispatch=30)`` for 3
   windows at tier auto: window 1 runs 2 eager warm-up steps, captures
   the step as a CUDA graph and replays it 28 times; windows 2-3 only
   replay, under ``torch.cuda.set_sync_debug_mode("error")`` (no host
   sync inside a window). B1 counts are zeroed just before and read
   after: 49 launches through the wrapper for each of the 3 eager
   forwards (warm-up and capture), no fallback; one graph, no eager
   step after the warm-up, 88 replays, the update count at 90; f32
   masters; moving statistics f32 and moved; window 1's losses against
   K = 1 from the same start within 5e-3 relative at step 1 and 5e-2 at
   every step, and falling. Two more windows under torch.profiler (the
   first in its warm-up cycle): 49 x 30 B1 kernels on the device in the
   second (33 + 16 an inner step). Printed: the
   grouped step (wall over windows 2-3 / 60), images/s and share of the
   bf16 peak beside phase 13's per-step p50, the busy share, the peak
   memory, the capture time and window 1's wall. Then ``fit`` on
   defaults (``eval_metric="acc"``, no K given) over 32 batches: K must
   be ``MXNET_STEPS_PER_DISPATCH``'s 16 with the metric on the device,
   equal to the accuracy of the same outputs counted on the host. Then
   phase 8's GPT cut to 2 layers (batch 8 x 1024, Adam, tier auto)
   (epsilon 1e-4) through ``fit(steps_per_dispatch=4)`` against K = 1
   from the same weights with phase 9's bounds between tiers: losses
   within 1e-4 relative, the parameters within 1e-3 (the L2 norm of
   their difference over that of the K = 1 update); every update count
   4, one graph;
   a replayed window's census 1 B2, 2 B3 and 2 B5 kernels an inner step
   and no launch through the wrappers. Last a small f32 MLP with
   Dropout(0.5) trained by Adam with K = 4 and K = 1 from
   ``random.seed(5)``: losses and parameters bitwise equal (a mask or
   Adam's bias correction frozen into the graph would part them) and
   the key chains equal.
16. Recommend: ``bench.py``'s recommend leg at its chip sizes, nothing
   cut. B2 first, bitwise its plain gather with out-of-range ids, and
   timed (as phase 3) beside ``index_select`` of the clipped ids and its
   bound, at the served lookup's (1024, 64) cache by 16 x 64 slots, a
   (8192, 64) cache by 512 ids and the matrix factorization's (200, 16)
   table by 256 ids. Then the two-tower training: spill stores of 65536
   (seed 1) and 4096 (seed 2) rows of 64 f32 from ``row_init``, hot-row
   caches of 8192 and 4096 rows, 30 steps of 512 (Zipf(1.3)
   user ids, uniform item ids, normal ratings from ``RandomState(0)`` in
   ``bench.py``'s order), each ``bench.py``'s step in torch (a sum of
   each row's contributions in batch order, then one SGD update at lr
   0.1) between ``ensure`` and ``note_updated``; then ``flush``. The
   same 30 steps run again under torch.profiler (the step's device
   time) and once on dense tables: all three runs' final tables must be
   bitwise equal, and the cache must have spilled. Printed: the wall ms
   a step over steps 2-30, its device ms, the user cache's hit rate,
   evictions, spill and upload bytes. Then ``export_recommend`` of the
   flushed tables (max 64 ids, k 10) and ``Server(path,
   queue_depth=64)`` with the engine's defaults (buckets 1/4/16, a
   1024-row cache) answering 256 requests of ``measure_recommend``'s
   traffic (RandomState(0), longtail lengths of mean 8 in 1..64, Zipf
   ids) at concurrency 8, twice: cold, as ``bench.py`` measures it,
   then warm. Counts zeroed just before each run, read just after: one
   B2 launch and one dispatch per executed batch, no fallback, one
   device-to-host copy per batch, the cache buffer in place. Every
   response against a float64 numpy oracle on the exported tables
   (mean of the rows, corpus scores, stable top 10): the items rank
   for rank, save near ties (a returned item's oracle score within
   rtol 1e-5 of the oracle's at its rank), the scores within rtol
   1e-5; ``check_discipline()`` clean. Printed: goodput QPS, request
   p50/p99, the batches by bucket, the engine's and cache's stats, and
   a 16-request batch's wall and device time and busy share from
   torch.profiler. Last ``examples/matrix_factorization.py``'s
   ``MFBlock`` at its defaults (200 users, 150 items, factor 16,
   ``groupadagrad`` lr 0.05, ``Normal(0.1)``, ``L2Loss``, its synthetic
   ratings of seed 0, batch 256): one step on the card against the
   same step on the CPU within 1e-5, the rows of zero gradient bitwise
   unchanged and the others moved; then two epochs, whose RMSE must
   fall, with 2 B2 launches and dispatches a forward.
17. Recurrent networks: the fused RNN op, ``gluon.rnn``, ``mx.rnn`` and
   ``BucketingModule``, nothing cut in width. B2 first, bitwise and
   timed as in phase 16, at the recurrent encoders' shapes: (10000, 200)
   and (10000, 650) tables by (32, 35) ids, char_lstm's (29, 32) by
   (16, 25). (a) ``tools/bench_lstm.py``'s net and loop: Embedding(10000,
   200) -> ``gluon.rnn.LSTM(200, num_layers=2, layout="NTC")`` ->
   Dense(10000, flatten=False), Xavier, hybridized, SoftmaxCrossEntropy,
   SGD lr 0.1, batch 32 x 35 ids from ``RandomState(0)``: one warm-up
   step, then 10 steps with one sync at the end (bench_lstm.py's
   tokens/s). (b) ``examples/word_language_model.py``'s RNNModel and loop
   (``tests/gluon_lstm_lm.py``) at the upstream medium widths (emsize =
   nhid = 650, 2 layers, dropout 0.5, tied, bptt 35, batch 32, vocab
   10000, random ids from ``RandomState(0)``): first one step on the
   card against the same step on the CPU (the weights carried across,
   the key chain seeded alike, dropout on): the loss and every
   parameter within 1e-4 of its largest magnitude. For both: 10 synced
   steps (tokens/s, step p50), the forward/backward/update split by CUDA
   events, torch.profiler's device ms, busy share and kernel launches a
   step, the peak memory, and the model FLOPs over 67 TFLOP/s; B2's
   counts zeroed before and read after the timed steps: one launch a
   step (the encoder; the tied decoder reads the same weight through its
   product), no tier fallback. ``begin_state`` shapes checked. Beside
   each, a yardstick not on the path: cuDNN's ``torch.nn.LSTM`` loaded
   with the same weights, its outputs within 1e-5 of the port's RNN op
   (relative to the largest magnitude), forward + backward timed for
   both. Last ``examples/char_lstm.py`` at its defaults (its corpus,
   buckets (13, 25), ``mx.rnn.LSTMCell(64)``, ``BucketingModule``,
   Xavier, Adam lr 3e-3, batch 16, ``Perplexity(ignore_label=0)``) for 3
   epochs: the perplexity must fall, one B2 launch a step, no fallback.
18. The data pipeline (ROADMAP A5): ResNet-50 v1 trained from
   ``.rec`` records as ``examples/train_imagenet.py`` trains it, at
   ``bench.py``'s record count (768), batch 128 and chip K (30), bf16
   over f32 masters. The records repeat the 16 JPEGs of
   ``tests/data/jpeg_fixture`` (224-300 pixels a side, 4:2:0 and 4:4:4,
   qualities 75-95) with labels i % 1000. Checks, each failing the run:
   (1) every fixture image decoded on the card (nvJPEG's planes, then
   the ``jpeg_color`` kernel) against cv2's stored pixels: per channel
   mean |delta| at most 1.0 level and its 99.9th percentile at most 8
   levels; the fixture's block JPEGs (constant 8 x 8 blocks, which any
   inverse DCT gives back exactly) bitwise cv2's; (2) the ``image_aug``
   kernel bitwise its plain version on the decoded images, the
   ImageNet recipe (random 224 crops and mirrors) in f32, bf16 and f16
   at batch 128 and the CIFAR recipe (pad 4, fill 255, mean/std, 32
   crops), and ``jpeg_color`` bitwise its plain version on random
   planes at the fixture's shapes; (3) an epoch of
   ``ImageRecordIter(ctx=gpu(0), shuffle, rand_crop, rand_mirror, 8
   threads)`` against the batches the plain augment builds from cv2's
   pixels in the same order with the same draws (restated here from the
   JAX package's rule): labels equal, pixels within (1)'s bound in the
   epoch and in every image; (4) ``fit`` through the records staged
   (``StagedKFeed``) and unstaged, K = 2 for 2 windows, cuDNN
   deterministic: every parameter and moving statistic bitwise equal.
   Then the main path, the counts of B1, ``image_aug``, ``jpeg_color``
   and nvJPEG zeroed just before and read just after: ``fit(ResizeIter(
   ImageRecordIter), steps_per_dispatch=30)`` for 30 batches (the
   capture) and 150 more (timed, 5 windows): one graph, 178 replays,
   49 x 3 B1 launches through the wrapper (2 warm-up steps and the
   capture), one ``image_aug`` and one ``jpeg_color`` launch a batch
   made. Printed: the fit leg's images/s over the 5 windows and after
   window 1's data came (each ``fit`` call starts a new feed, which
   fills during window 1), beside the replayed one-batch step's in the
   same run; the input side alone (decode, augment, stage; no
   training); the overlap ratio (achieved / min(input, compute), as
   ``bench.py`` defines it); the data wait per window from ``fit``'s
   own accumulator; the same legs over a file of 19200 records, whose
   one epoch covers the timed leg (768 records end an epoch every 6
   batches, and each end restarts the iterator's feeder), and from the
   two the time a later window loses to epoch ends and to the input
   side working beside the step; nvJPEG's and the kernels' ms per batch
   (CUDA events, the kernels from descriptor tables already on the
   card with the wrappers' time beside; cv2's host decode beside as a
   yardstick where cv2 is installed); the bytes copied host to device
   per batch (torch.profiler's memcpy records); the busy share of a
   profiled window and the peak memory.
19. The one-process kvstore, checkpoints and resume, and
   ``examples/train_imagenet.py``'s own loop (ROADMAP A6a, A6b, A3b.8),
   over phase 18's records and phase 13's ResNet-50 symbol, cuDNN held
   to deterministic algorithms wherever runs are compared bitwise.
   (a) ``tools/bandwidth.py``'s ``measure`` leg through ``mt.kv``: 1 MB
   of f32 from RandomState(0), one warm-up and 20 synchronized push +
   pull repetitions, ``local`` and ``device``, one value and two card
   values summed, compression none and 2-bit (threshold 0.5): the pull
   bitwise the pushed sum; over 3 pushes with the residual carried the
   2-bit pull bitwise a numpy copy of ``_compress``; ``_pack_2bit`` on
   the card bitwise numpy's and ``_dequantize_2bit`` giving it back.
   Printed per case: us a push + pull, GB/s by ``measure``'s byte
   formula, the bound (bytes read and written over 3.35 TB/s) and
   ``_last_wire_bytes``. Then every ResNet-50 parameter array as one list
   of keys, pushed and pulled through ``local`` (bitwise) and through
   ``dist_sync`` in one process with an SGD momentum updater (bitwise the
   Module's Updater on the same gradients). (b) The loop's calls through
   ``mt``: ``Module(sym, context=gpu(0)).fit`` over
   ``ResizeIter(ImageRecordIter, 30)`` epochs (2), batch 128 in bf16
   over f32 masters, SGD lr 0.05 momentum 0.9 wd 1e-4, metric acc,
   ``Speedometer(128, 20)`` and ``do_checkpoint(prefix)`` (each save
   timed), with ``kvstore="tpu_sync"`` and with a ``mt.kv.create("local")``
   object, per step (the automatic K with a callback) and at
   ``steps_per_dispatch=30``: B1's counts zeroed before and read after
   each per-step run, 49 launches a forward and no fallback, the losses
   falling; the K = 30 runs one capture each; every epoch's checkpoint
   read back by ``load_checkpoint`` bitwise ``get_params()`` at the save.
   Printed: images/s per run (and without the epoch-end saves), the save
   times, Speedometer's own lines. Then the ``--load-epoch 1`` restart:
   ``load_checkpoint`` and a new Module's ``fit(arg_params=,
   aux_params=, begin_epoch=1)``. (c) Resume: ``fit(checkpoint=
   CheckpointManager(dir, save_every=30, keep_n=2),
   steps_per_dispatch=30)`` for 60 steps, a new Module resumed under
   ``MXNET_RESUME_DIR`` to 120, against an uninterrupted 120: the
   parameters, moving statistics, momentum and the next batch's labels
   bitwise (or, if a second uninterrupted run is not bitwise the first,
   within the two runs' spread); a blocking and an async save of the
   snapshot timed, its bytes printed. (d) ``predict``, ``iter_predict``
   and ``score`` over 2 batches of unaugmented records bitwise
   ``forward`` on the same batches; then ``fit(monitor=Monitor(...))``
   for 3 steps: the fused step dropped, its momentum kept in the
   Updater and moving, the Monitor's statistics equal to those of the
   arrays it names. (e) Gluon ``resnet50_v1`` (batch 32, 3 steps):
   ``Trainer(kvstore=mt.kv.create("device"))`` bitwise
   ``kvstore="device"``; ``compression_params={"type": "2bit",
   "threshold": 0.5}``, the pulled gradients bitwise a numpy copy of the
   quantize of the card's gradients; ``save_checkpoint``, then
   ``restore_checkpoint`` into a new net, whose next step is bitwise.
   The phase's wall time is printed.
20. The other ImageNet networks (ROADMAP A3b.5b): Inception-v3
   (3x299x299, 1000 classes, 94 conv -> BatchNorm(fix_gamma, eps 1e-3)
   -> ReLU sites, each fused into one B1 launch), AlexNet with LRN, and
   the Gluon zoo. (a) B1 against its plain version at each of the 18
   distinct site shapes, bf16 at batch 128 and f32 at batch 32 (phase
   3's tolerances), each timed as in phase 3 (both flushes) beside its
   bound, and the sums over the 94 sites beside theirs. (b) Inception-v3 with
   uniform(-0.05, 0.05) weights from RandomState(0) exported with a
   dynamic batch and served with buckets (1, 8, 32) as phase 4 serves
   ResNet-50: counts zeroed just before and read just after, 94
   ``bn_act`` launches each executed forward and no fallback; answers
   against the same artifact at kernel_tier=off on the card (1e-5 abs)
   and one image against the CPU (1e-5 abs); p50/p99 and images/s per
   bucket, closed loop. (c) ``examples/train_imagenet.py --benchmark 1
   --network inception-v3 --image-shape 3,299,299``'s ``fit`` through
   ``mt``: one synthetic batch of 128 on the card, train_imagenet.py's
   Xavier(gaussian, in, 2) drawn once from seed 0, SGD lr 0.05 momentum
   0.9 wd 1e-4 in bf16 over f32 masters, ``tpu_sync``, the key chain
   seeded 0 before each run (Dropout 0.5 draws its masks from it).
   10 steps per step (K 1): 94 launches a forward, no fallback, losses
   finite and falling, the moving statistics f32 and moved; the step p50
   and images/s, the model FLOPs counted from the symbol (2 x the
   multiply-adds of every convolution and FullyConnected, 3 x the forward
   for a step) over the bf16 peak, the peak memory, and one profiled
   step (busy share, B1's device time, the top kernels). Tier off's first
   step from the same start within 5e-3 relative of auto's loss. Then 3
   epochs of 30 steps at ``steps_per_dispatch=30``: one capture, the
   wrapper counting the 2 warm-up steps and the capture only, the first
   loss within 5e-3 of K 1's, the step time over windows 2-3; and a
   profiled replayed window whose census (``graph_census``) counts 94 x
   30 B1 kernels. Card against CPU at batch 2 and 139x139 (the smallest
   input the symbol takes), f32 and bf16, with ``resnet_card_vs_cpu``'s
   bounds (the f32 outputs within 1e-4 relative L2, or twice the CPU's
   own change under a 1e-7 relative noise on the images where that is
   more), the ReLU inputs of opposite sign counted. Every count is of
   every kernel: the others stay 0. (d) AlexNet: the LRN op at both its
   sites (batch 2, f32) on the card against the CPU, forward and
   gradient within 1e-5 of the largest magnitude; B5 at fc6 and fc7's
   shape, (128, 4096) + bias -> ReLU (the fusion pass's ``fc_act``
   plan), f32 and bf16, against its plain version and its gradients as
   phase 7 holds them, timed beside its bound; then the loop of (c) at
   3x224x224, batch 128, f32 and bf16, 5 steps each, counts zeroed just
   before and read just after: 2 B5 launches a forward, nothing else, no
   fallback (losses finite; step p50 and images/s). (e) Every
   ``get_model`` name on the card (Xavier, the key chain seeded 0): a
   hybridized forward at batch 32 (299 for ``inceptionv3``, 224 for the
   rest) against the eager one (1e-5 of the largest magnitude) and at
   batch 2 against the CPU with the card's weights (1e-4); images/s of
   the hybridized forward; then 3 ``Trainer`` steps (SGD, f32, batch 32)
   of ``mobilenetv2_1.0`` and ``densenet121`` with finite losses. Gluon
   fuses nothing, so no kernel launches in (e). The phase's wall time
   is printed.
21. Object detection, BASELINE config 4 (ROADMAP A9's detection slice), through
   ``tests/detection_graphs.py``, the two examples spelled over ``mt``
   (the examples import the JAX package). (a) Every detection op on the
   card against the port on the CPU, the same seeded inputs with ties
   planted (equal scores, equal background probabilities, all-zero ROI
   bins): ``box_nms`` over 2 x 5120 boxes (plain and class-aware with
   topk) and ``bipartite_matching`` bitwise; ``MultiBoxTarget`` at SSD's
   5120 anchors (its mask and mined classes bitwise, offsets within
   1e-5), ``MultiBoxDetection`` (class ids and kept rows bitwise, values
   within 1e-5), ``MultiBoxPrior``, ``Proposal`` at R-CNN's shape (batch
   indices and padding bitwise, boxes within 1e-4 of 128-pixel
   coordinates), ``ROIPooling`` and ``ROIAlign`` with their gradients at
   R-CNN's (2, 64, 8, 8) feature map and 32 ROIs (1e-5); the host NMS
   walks and their copied bytes printed. B1 at SSD's site shapes and B5
   at R-CNN's fc6 shape (32, 128) + bias -> ReLU against their plain
   versions (phase 3's and phase 7's tolerances), timed beside their
   bounds. (b) ``examples/train_rcnn.py``'s fit at its settings (IMG
   128, stride 16, 3 anchors, 16 ROIs an image, batch 2, 64 synthetic
   images of seed 7, SGD lr 0.01 momentum 0.9 wd 5e-4, kvstore
   ``local``, ``RCNNMetric``, the example's Xavier as the JAX package
   draws it from numpy after ``numpy.random.seed(7)``): first one step
   on the card against the CPU, the CPU replaying the card's custom-op
   outputs (its ROIs and samples), outputs within 1e-4 and gradients
   within 1e-3 relative L2; then 5 epochs at the automatic K (1: the
   graph holds the ``Custom`` and ``Proposal`` host ops, so its steps run
   uncaptured, read from the graph) and 1 epoch at
   ``steps_per_dispatch=4`` (uncaptured): counts zeroed before and read
   after, one B5 launch a forward at fc6 and nothing else, no fallback;
   the loss falling over the epochs (the last below the first,
   ``check_improved``'s rule); step wall by epoch, the custom op's round
   trips and their host us, the NMS walks; 8 profiled steps (wall,
   device time, busy share). (c) ``examples/train_ssd.py``'s fit from
   the detection fixture (``tests/data/det_fixture``, packed into
   records here) through ``mt.image.ImageDetIter`` on the card (nvJPEG,
   shuffled, mirrored, batch 8 at 64x64, ``ResizeIter`` of 8 batches),
   4 epochs, kvstore ``tpu_sync``, ``Speedometer(8, 4)``,
   ``MultiBoxMetric``, the example's Xavier drawn as in (b) from seed 7:
   4 B1 launches a forward and nothing else, every image decoded by
   nvJPEG, the loss falling; images/s; then the reference SSD's
   inference head (softmax, ``MultiBoxDetection``, nms_topk 400) over one
   batch with the trained weights: 4 B1 launches, the detections' class
   ids and kept rows bitwise the port's CPU op on the card's own
   probabilities and offsets, values within 1e-5, the op's host wall.
   The phase's wall time is printed.
22. The common ops and the optimizers (ROADMAP A3b.2 and A3b.6), BASELINE
   configurations 3 and 1 through ``tests/example_nets.py`` (the examples
   spelled over ``mt``). (e) First, every new op family on the card
   against the port on the CPU, one input set each: movement, index,
   ordering (ties planted), rounding, sign, logical and integer ops
   bitwise, the transcendental ops within rtol 1e-5, atol 1e-6, sums
   and the 16 update ops within rtol 1e-5, atol 1e-4. (a)
   ``examples/super_resolution.py`` at its defaults: the ESPCN net
   (64-64-32-4 filters at 5/3/3/3, ``depth_to_space``), 128 synthetic
   pairs of 32 -> 64 pixels (seed 0), ``NDArrayIter`` shuffled at batch
   16, ``Orthogonal``, ``hybridize(static_alloc=True)``, ``L2Loss``,
   Adam lr 1e-3, 6 epochs: first one step on the card against the CPU
   from the same weights (outputs within 1e-4, gradients within 1e-3
   relative L2), then the run with every count zeroed before and read
   after (no kernel on this path, no fallback), the PSNR rising; epoch
   wall, images/s, 4 profiled steps' busy share. (b)
   ``examples/train_mnist.py`` at its defaults (the synthetic stand-in,
   ``mlp_symbol``, batch 64, 5 epochs, SGD lr 0.1 momentum 0.9, kvstore
   ``local``, ``Speedometer``): B5 at fc1 (64, 128) and fc2 (64, 64)
   against its plain version, timed beside its bound; the run's B5
   launches held to the fusion plan's 2 a forward over every training
   and validation forward, nothing else, no fallback; the validation
   accuracy above the one before training. (c)
   ``examples/train_cifar10.py`` at its defaults (ResNet-20 at 3x28x28,
   the synthetic stand-in, batch 128, 10 epochs, SGD lr 0.05 momentum
   0.9 wd 1e-4 ``multi_precision``, ``MultiFactorScheduler``,
   ``tpu_sync``, ``eval_data`` with ``eval_end_callback``, a checkpoint
   at every epoch's end): B1 at ResNet-20's site classes (bf16, batch
   128) against its plain version, timed; the run's B1 launches held to
   the plan's count a forward over every forward, nothing else, no
   fallback, the fused step in bf16; the last checkpoint read back
   bitwise; the validation accuracy above the one before training; step
   p50 and images/s. (d) Each of the ten new optimizers: 3 steps of
   ResNet-20 at batch 16 through ``Module.fit`` on the card (kvstore
   ``local``, lr 0.01; fused where the optimizer has a fused form), SGD
   with momentum beside them, then the same optimizer on the CPU applying
   the card's own gradients in the card's order: every card weight within
   1e-4 of the largest update of the CPU's. First the witness: one step's
   outputs and gradients from the same weights, card and CPU, tier auto
   and off, each against the CPU's f64 step (outputs within 1e-5,
   gradients within 5e-2 relative L2 at the worst parameter, every ReLU
   flip of the CPU's paths at a pre-activation below 1e-4). The phase's
   wall time is printed.
23. Sparse linear classification (BASELINE configuration 5), the rest of
   ``ops/nn.py`` and the single-process examples nothing ran before,
   through ``tests/example_nets.py``. (a) C15: ``_sample_unique_zipfian``
   at range_max 5000, 50000 and 1000000, three seeds each, and
   ``random.exp_f32`` on all 2^23 of its inputs at each range, card
   bitwise the CPU. (b) ``LibSVMIter`` over the example's synthetic file
   (2000 rows, 1000 features, seed 0): two epochs of card batches
   bitwise the CPU's. (c) ``sparse.dot``, CSR and CSR transposed, on the
   first batch at the defaults (64 x 1000) and at the upstream example's
   Avazu width (8192 x 1,000,001, 12 entries a row): card within 1e-5
   relative L2 of the CPU, two card calls bitwise, the time beside the
   bound (bytes over 3.35 TB/s) and ``torch.sparse.mm`` (a yardstick off
   the path). (d) Each of the 19 ``ops/nn.py`` names of this slice on
   the card against the CPU, forward and the first input's gradient (CTC
   at T 100, N 32, C 29, L 20 with lengths; the legacy names included).
   (e) ``examples/sparse_linear_classification.py`` at its defaults
   (1000 features, batch 64, 6 epochs, AdaGrad lr 0.5, kvstore
   ``local``): no kernel launched, the accuracy rising (the example's
   ``check_improved``), the first epoch's weights within 1e-6 of a CPU
   replay. (f) The same loop at the Avazu width over 65,536 rows written
   by a vectorised draw of the example's law, 2 epochs: batches/s, then
   one epoch profiled (busy share). (g) ``examples/nce_word2vec.py`` at
   its defaults (vocab 512, dim 32, 15 negatives, batch 256, 300 steps):
   B2 at the two lookups' shapes against its plain version and timed,
   the first step against the CPU, then the run with B2 held to 2
   launches a step and nothing else, the NLL below 0.95 of its first
   value and the partner rate above 0.2 (the example's checks). (h)
   ``gluon_cnn.py``, ``train_dcgan.py`` and ``train_vae.py`` at their
   defaults: each one's first step on the card against the CPU from the
   same weights and key-chain seed (loss within 1e-4, gradients within
   1e-3 relative L2), then the run with no kernel launched (BatchNorm ->
   relu under Gluon fuses into no B1, as in the JAX package) and the
   example's own check (gluon_cnn.py has none: its loss must fall). The
   phase's wall time is printed.
24. Multi-process training (A6c), every part's ranks started by the
   port's launcher (``python -m mxnet_tpu_torch.tools.launch``) and
   sharing ``cuda:0`` over gloo, each rank ``python3 chip_smoke.py
   --worker <part>``; a failed rank fails the phase. (a) The reference
   nightly ``dist_sync_kvstore.py``'s invariants
   (``tests/torch_dist_worker.py``) at 2 ranks (first in part b's
   launch) and 3 ranks, every value on the card, with ``dist_async``
   through rank 0's server and, at 3 ranks, ``get_num_dead_node`` while
   the last rank stops beating. (b)
   ``examples/sparse_linear_classification.py`` at phase 23's Avazu width,
   2 ranks on their halves (``num_parts``/``part_index``), 2 epochs at
   ``dist_sync`` and at ``dist_async``: ``dist_sync``'s final weight and
   bias bitwise a one-process replay that pushes both ranks' gradients of
   each step as a list to a ``local`` store with the same AdaGrad;
   ``dist_async``'s accuracy rising, its weights finite and every push
   applied once (the server's log); batches/s, the all-reduce's ms and
   bytes a push, one epoch profiled (busy share). (c) ResNet-50 as
   ``train_imagenet.py --benchmark 1 --kv-store dist_sync`` (2 ranks x
   batch 64, SGD 0.05/0.9/1e-4 with f32 masters, Xavier(in, 2) seed 0,
   cuDNN deterministic), 8 steps each: the kvstore path, ``MXNET_DDP``
   at 1 MiB, the automatic size (no ``MXNET_DDP_BUCKET_MB``) and 64 MiB
   buckets (bf16), and DDP at 64 MiB in f32. Every
   rank's weights bitwise each other's, the bucket sizes bitwise each
   other, DDP in f32 bitwise the kvstore path (the kvstore path updates
   in the store, outside the fused step, so it computes in f32), the
   first step's all-reduced gradient bitwise a one-process replay of the
   two half-batches, B1 49 launches a forward on each rank with no
   fallback (its kernel checked and timed at batch 64, bf16 and f32),
   losses falling; step p50, images/s over both ranks beside phase 13's
   step, the all-reduce's ms, bytes and calls a step, peak memory, 2 DDP
   steps profiled (busy share). (d) ``train_mnist.py``'s MLP at
   ``dist_sync``, 2 ranks, 2 epochs: run 1 uninterrupted; run 2 with
   ``MXNET_FAULT_INJECT=kill@step=7:rank=0``, ``--max-restarts 1`` and
   ``--checkpoint-dir``, resumed by the launcher from the newest common
   snapshot, its final weights bitwise run 1's; B5 2 launches a forward
   on each rank; run 2's checkpoint resharded to one rank
   (``reshard_checkpoint``) and restored by ``restore_resharded`` bitwise
   the gathered state. Each part's wall is printed.
25. The whole run's wall time, then the ``kernels`` JSON line (B1's
   entry has ``_contrib_FusedBNAct``, ``grouped``, ``records``,
   ``imagenet_loop``, ``inception_v3_serve``, ``inception_v3_train``,
   ``ssd_train``, ``ssd_detect``, ``cifar10_train``, ``dist_resnet_bf16``
   and ``dist_resnet_f32`` among its paths, B2, B3 and B5 ``grouped``, B5
   ``alexnet_train/float32``, ``alexnet_train/bfloat16``, ``rcnn_train``,
   ``mnist_train/fc1``, ``mnist_train/fc2``, ``dist_mnist/fc1`` and
   ``dist_mnist/fc2``, B2
   ``recommend``, ``matrix_factorization``,
   ``lstm_bench``, ``word_lm``, ``char_lstm`` and ``nce_word2vec``;
   ``image_aug`` and
   ``jpeg_color``, which no TPU kernel stands behind), the card's
   nvidia-smi line, and last the result line ``{"ok": true, "device":
   {...}}``.

It needs one CUDA card and the repository checkout around it; without
either it fails before printing a result.
"""
import argparse
import gc
import json
import logging
import math
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.kernels import _build, bn_act, graph_fuse, tier
from mxnet_tpu_torch.symbol.symbol import _infer_shapes

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM, published
F32_FLOPS = 67e12                # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12              # H100 SXM TF32 tensor cores, dense
BF16_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
BUCKETS = (1, 8, 32)
REPLACES = {"bn_act": "mxnet_tpu/kernels/bn_act.py:57",
            "bn_act_res": "mxnet_tpu/kernels/bn_act.py:65"}
SOURCE = "mxnet_tpu_torch/csrc/bn_act.cu"


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


# ------------------------------------------------------------------ sites
def resnet50():
    return mt.models.resnet(num_layers=50, num_classes=1000,
                            image_shape=(3, 224, 224))


def planned_sites(sym, chw):
    """[(form, (C, H, W))] for every planned bn_act site of ``sym`` at an
    input of ``chw``, from the port's own fusion plan and shape
    inference."""
    with mt.config.override(kernel_tier="auto"):
        plans, _ = graph_fuse.plan(sym._topo(), list(sym._entries))
    shapes = _infer_shapes(sym, {"data": (1,) + tuple(chw)})
    sites = []
    for p in plans.values():
        src, oi = p.base.inputs[0]
        sites.append(("bn_act" if p.res_entry is None else "bn_act_res",
                      tuple(shapes[(id(src), oi)][1:])))
    return sites


def fused_sites(sym):
    """ResNet-50's planned bn_act sites (``planned_sites`` at 224x224),
    the census held at 33 + 16."""
    sites = planned_sites(sym, (3, 224, 224))
    n_plain = sum(1 for f, _ in sites if f == "bn_act")
    if (n_plain, len(sites) - n_plain) != (33, 16):
        raise RuntimeError("ResNet-50 fusion census is %d + %d, not 33 + 16"
                           % (n_plain, len(sites) - n_plain))
    return sites


# --------------------------------------------------------- kernel checks
def make_case(shape, dtype, residual, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    C = shape[1]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    r = (torch.randn(shape, generator=g, device=dev).to(dtype)
         if residual else None)
    sc = torch.rand(C, generator=g, device=dev) * 2 - 0.5
    sh = torch.randn(C, generator=g, device=dev)
    return x, sc, sh, r


def b1_bad(y, ref):
    """B1's tolerance (f32 1e-5 abs + rel; bf16 one ulp + 1e-5) ->
    (|y - ref| over the finite outputs, elements past it); every NaN and
    infinity of ``ref`` must be in ``y`` too, and no other."""
    yf, rf = y.float(), ref.float()
    inf = torch.isinf(rf)
    if not (torch.equal(torch.isnan(yf), torch.isnan(rf))
            and torch.equal(torch.isinf(yf), inf)
            and torch.equal(yf[inf], rf[inf])):
        raise RuntimeError(
            "bn_act kernel: NaN or infinity where its plain version has none "
            "or another (%d NaN against %d, %d inf against %d)"
            % (int(torch.isnan(yf).sum()), int(torch.isnan(rf).sum()),
               int(torch.isinf(yf).sum()), int(inf.sum())))
    diff = torch.where(torch.isfinite(rf), (yf - rf).abs(),
                       torch.zeros_like(rf))
    if y.dtype == torch.float32:
        bad = diff > 1e-5 + 1e-5 * rf.abs()
    else:
        ulp = torch.maximum(yf.abs(), rf.abs()) * 2 ** -7
        bad = diff > ulp + 1e-5
    return diff, bad


def check_kernel(x, sc, sh, r, act="relu"):
    """Kernel vs plain on the card -> max abs error; raises past the
    stated tolerance."""
    y = bn_act._launch(x, sc, sh, r, act, bn_act.DEFAULT_CONFIG)
    ref = bn_act._plain_epilogue(x, sc, sh, r, act)
    torch.cuda.synchronize()
    diff, bad = b1_bad(y, ref)
    if bool(bad.any()):
        # what tells a systematic fault from a one-off corrupted value:
        # how many elements, the worst one's inputs, and a second launch
        i = int(diff.flatten().argmax())
        ch = i // (x.shape[2] * x.shape[3]) % x.shape[1]
        again = bn_act._launch(x, sc, sh, r, act, bn_act.DEFAULT_CONFIG)
        torch.cuda.synchronize()
        raise RuntimeError(
            "bn_act kernel disagrees with its plain version at %s %s "
            "residual=%s act=%s: max abs err %g in %d of %d elements; worst "
            "at flat index %d (channel %d): kernel %r, plain %r, x %r, sc "
            "%r, sh %r; a second launch on the same inputs is off by %g"
            % (tuple(x.shape), x.dtype, r is not None, act,
               float(diff.max()), int(bad.sum()), x.numel(), i, ch,
               float(y.flatten()[i]), float(ref.flatten()[i]),
               float(x.flatten()[i]), float(sc[ch]), float(sh[ch]),
               float(b1_bad(again, ref)[0].max())))
    return float(diff.max())


# B1's index paths in csrc/bn_act.cu: rows of odd length (147x147, 17x17,
# 7x7), rows a multiple of a vector (8x8, 56x56), rows shorter than a
# vector (1x1, 2x3), one channel, element counts no multiple of 8
B1_EDGE_SHAPES = ((2, 3, 147, 147), (3, 5, 17, 17), (4, 6, 7, 7),
                  (2, 5, 8, 8), (2, 3, 56, 56), (3, 7, 1, 1), (2, 5, 2, 3),
                  (3, 1, 9, 11), (2, 1, 8, 8))
# storage offsets (elements) of x and of r: 16-byte alignments other than y's
B1_EDGE_OFFSETS = ((1, 1), (3, 3), (1, 3), (0, 1))


def at_offset(t, off):
    """A contiguous copy of ``t`` that starts ``off`` elements into its
    storage."""
    buf = torch.empty(off + t.numel(), dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def plant_nonfinite(x):
    """NaN, +inf, -inf and -0.0 at the ends of the tensor, at the first
    row boundary and in the middle."""
    hw, n = x.shape[2] * x.shape[3], x.numel()
    flat = x.view(-1)
    vals = (float("nan"), float("inf"), float("-inf"), -0.0)
    for k, i in enumerate((0, 1, hw - 1, min(hw, n - 1), n // 2, n - 2,
                           n - 1)):
        flat[i] = vals[k % len(vals)]
    return x


def b1_graph_check(dev):
    """One B1 launch captured in a CUDA graph and replayed: bitwise the
    eager launch, and again after new values are copied into x."""
    x, sc, sh, r = make_case((32, 64, 35, 35), torch.bfloat16, True, dev, 9)

    def launch():
        return bn_act._launch(x, sc, sh, r, "relu", bn_act.DEFAULT_CONFIG)
    eager = launch()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        launch()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = launch()
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(y, eager)
    x.copy_(x.flip(0))
    eager = launch()
    graph.replay()
    torch.cuda.synchronize()
    if not (same and torch.equal(y, eager)):
        raise RuntimeError("bn_act: the replayed graph differs from the "
                           "eager launch")


def b1_edge_phase(dev):
    """B1 against its plain version on B1_EDGE_SHAPES, both dtypes, both
    forms, both activations; on the same values with NaN, +-inf and -0.0
    planted in x; with x and r at B1_EDGE_OFFSETS; then captured and
    replayed in a CUDA graph."""
    cases, err, seed = 0, 0.0, 500
    for shape in B1_EDGE_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for residual in (False, True):
                seed += 1
                x, sc, sh, r = make_case(shape, dtype, residual, dev, seed)
                for xx in (x, plant_nonfinite(x.clone())):
                    for act in ("relu", "identity"):
                        err = max(err, check_kernel(xx, sc, sh, r, act))
                        cases += 1
                for ox, orr in B1_EDGE_OFFSETS:
                    err = max(err, check_kernel(
                        at_offset(x, ox), sc, sh,
                        None if r is None else at_offset(r, orr)))
                    cases += 1
    b1_graph_check(dev)
    log("B1 index paths vs plain: %d cases (%d shapes x {f32,bf16} x "
        "{plain,residual} x {relu,identity} x {finite, NaN/inf/-0.0 "
        "planted} and at storage offsets %s) agree, max abs err %g; a "
        "launch captured in a CUDA graph replays bitwise"
        % (cases, len(B1_EDGE_SHAPES), list(B1_EDGE_OFFSETS), err))


def time_ms(fn, dev, iters=20, warmup=3, hide_host=True, clean_l2=False):
    """Median CUDA-event time of fn(), L2 flushed before every launch.

    With ``hide_host`` the stream first spins (torch.cuda._sleep) long
    enough for the host to enqueue fn() behind it, so the events time
    the device work alone; without it the time includes whatever the
    host makes the device wait (an eager forward's op-by-op dispatch).
    The flush writes 96 MB, so L2 starts full of dirty lines whose
    write-back shares HBM with fn()'s reads; ``clean_l2`` flushes by
    reading the 96 MB instead, leaving L2 clean.
    """
    flush = torch.empty(96 << 20, dtype=torch.uint8, device=dev)
    for _ in range(warmup):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    if clean_l2:
        flush.zero_()
    for s, e in zip(starts, ends):
        if clean_l2:
            flush.max()
        else:
            flush.zero_()
        if hide_host:
            torch.cuda._sleep(1_000_000)      # ~0.5 ms at 1.98 GHz
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e)
                            for s, e in zip(starts, ends)]))


def wrapper_host_us(dev, n=200):
    """Host time of one kernel launch through the Python wrapper."""
    x, sc, sh, r = make_case((1, 64, 8, 8), torch.float32, False, dev, 3)
    for _ in range(10):
        bn_act._launch(x, sc, sh, r, "relu", bn_act.DEFAULT_CONFIG)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        bn_act._launch(x, sc, sh, r, "relu", bn_act.DEFAULT_CONFIG)
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def bound_parts(shape, dtype, residual):
    """Least time for the work, as (bytes_ms, ops_ms): x (and r) read
    once, y written once, the two coefficient vectors read once, over
    the HBM rate; ~4 f32 flops per element over the f32 peak. The bound
    is the larger of the two."""
    n = int(np.prod(shape))
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes = n * size * (3 if residual else 2) + 2 * shape[1] * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, 4 * n / F32_FLOPS * 1e3


def bound_of(bytes_ms, ops_ms):
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


B1_SUM_KEYS = ("kernel_ms", "kernel_clean_ms", "plain_ms", "copy_ms",
               "bytes_ms", "ops_ms")


def b1_class_row(form, shape, dtype, sites, dev, seed, what):
    """One B1 site class: the kernel against its plain version (phase 3's
    tolerances), then its time with time_ms's dirty flush and with a clean
    L2, the plain version's time, torch's copy of x into y (a yardstick,
    not the same function), the bound and both shares -> the row."""
    residual = form == "bn_act_res"
    x, sc, sh, r = make_case(shape, dtype, residual, dev, seed)
    err = check_kernel(x, sc, sh, r)

    def kernel():
        bn_act._launch(x, sc, sh, r, "relu", bn_act.DEFAULT_CONFIG)
    k = time_ms(kernel, dev)
    kc = time_ms(kernel, dev, clean_l2=True)
    p = time_ms(lambda: bn_act._plain_epilogue(x, sc, sh, r, "relu"), dev)
    y = torch.empty_like(x)
    cp = time_ms(lambda: y.copy_(x), dev)
    del y
    bytes_ms, ops_ms = bound_parts(shape, dtype, residual)
    b, by = bound_of(bytes_ms, ops_ms)
    row = {"form": form, "shape": list(shape),
           "dtype": str(dtype).replace("torch.", ""), "sites": sites,
           "kernel_ms": k, "kernel_clean_ms": kc, "plain_ms": p,
           "copy_ms": cp, "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": b,
           "bound_by": by, "roofline_share": b / k,
           "roofline_share_clean": b / kc, "max_abs_err": err}
    log("  %s%-10s %-20s %-8s sites=%-2d kernel_ms=%.5f clean_l2_ms=%.5f "
        "plain_ms=%.5f copy_ms=%.5f bound_ms=%.5f (%s) share=%.3f clean=%.3f "
        "err=%.3g" % (what, form, tuple(shape), row["dtype"], sites, k, kc,
                      p, cp, b, by, b / k, b / kc, err))
    return row


def b1_totals(rows, what):
    """B1's rows summed over their sites -> the totals, logged."""
    tot = {key: sum(r[key] * r["sites"] for r in rows) for key in B1_SUM_KEYS}
    tot["bound_ms"], tot["bound_by"] = bound_of(tot["bytes_ms"],
                                                tot["ops_ms"])
    tot["roofline_share"] = tot["bound_ms"] / tot["kernel_ms"]
    tot["roofline_share_clean"] = tot["bound_ms"] / tot["kernel_clean_ms"]
    log("  %s: kernel_ms=%.4f (clean L2 %.4f) plain_ms=%.4f copy_ms=%.4f "
        "bound_ms=%.4f (%s), share %.3f (clean L2 %.3f)"
        % (what, tot["kernel_ms"], tot["kernel_clean_ms"], tot["plain_ms"],
           tot["copy_ms"], tot["bound_ms"], tot["bound_by"],
           tot["roofline_share"], tot["roofline_share_clean"]))
    return tot


def flash_bound_parts(q, pairs):
    """Least time of one f32 flash forward over q's shape with ``pairs``
    visible (query, key) pairs: (bytes_ms, ops_ms, core_ops_ms). Bytes:
    q, k, v read once and o written once. Operations: 4 flops per visible
    pair and head dim, three times over at the dense TF32 tensor-core
    rate (the kernel's error-compensated split: three products where
    both operands are f32) -- the bound the table uses; and once at the
    f32 CUDA-core rate, the bound of a kernel without tensor cores."""
    flops = 4 * pairs * q.shape[3]
    return (4 * q.numel() * 4 / HBM_BYTES_PER_S * 1e3,
            3 * flops / TF32_FLOPS * 1e3, flops / F32_FLOPS * 1e3)


def device_kernels(fn):
    """The names of the device kernels a call of fn runs, from
    torch.profiler (CPU and CUDA activities, as the other profiles here):
    names the library call timed beside a kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and e.self_device_time_total > 0]
    return " + ".join(n[:100] for n in names) or "not recorded"


def hgmma_count(name):
    """HGMMA (wgmma) instructions in ``cuobjdump -sass`` of the built
    library of csrc/<name>.cu: non-zero when it runs on tensor cores."""
    path = _build.build([name])[name]
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    return sass.count("HGMMA")


def log_flash_bound(name, r):
    log("  %-18s bound both ways: TF32 tensor cores (3 products) %.5f ms, "
        "f32 CUDA cores %.5f ms; library %s" % (
            name, r["bound_ms"], max(r["bytes_ms"], r["core_ops_ms"]),
            r["library_kernel"]))


def kernel_phase(sites, dev):
    distinct = sorted({chw for _, chw in sites})
    max_err = {}     # "form/dtype" -> max abs error
    seed = 0
    for batch in (1, 32):
        for chw in distinct:
            for dtype in (torch.float32, torch.bfloat16):
                for residual in (False, True):
                    seed += 1
                    err = check_kernel(*make_case((batch,) + chw, dtype,
                                                  residual, dev, seed))
                    key = "%s/%s" % ("bn_act_res" if residual else "bn_act",
                                     str(dtype).replace("torch.", ""))
                    max_err[key] = max(max_err.get(key, 0.0), err)
    log("kernel vs plain: %d shapes x batch {1,32} x {f32,bf16} x "
        "{plain,residual} agree; max abs err %s"
        % (len(distinct), json.dumps(max_err)))
    b1_edge_phase(dev)
    # times at batch 32, per shape class and form as the main path has them
    per_class = [b1_class_row(form, (32,) + chw, dtype,
                              sites.count((form, chw)), dev, 7, "")
                 for dtype in (torch.float32, torch.bfloat16)
                 for form, chw in sorted(set(sites))]
    totals = {}
    for dt in ("float32", "bfloat16"):
        rows = [r for r in per_class if r["dtype"] == dt]
        for form in ("bn_act", "bn_act_res", "all"):
            totals["%s/%s" % (dt, form)] = b1_totals(
                [r for r in rows if form in ("all", r["form"])],
                "batch-32 forward, %s/%s" % (dt, form))
    return max_err, per_class, totals


# --------------------------------------------------------------- main path
def draw_params(sym, chw=(3, 224, 224)):
    """bench.py's serving-leg draw: uniform(-0.05, 0.05) arguments, unit
    variances, zero means, from numpy RandomState(0)."""
    shapes, _, aux_shapes = sym.infer_shape(data=(2,) + tuple(chw))
    rng = np.random.RandomState(0)
    args = {n: rng.uniform(-0.05, 0.05, s).astype("f4")
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    aux = {n: np.ones(s, "f4") if "var" in n else np.zeros(s, "f4")
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def check_answer(out, rows):
    if out.shape != (rows, 1000) or not np.isfinite(out).all():
        raise RuntimeError("bad answer: shape %s, finite %s"
                           % (out.shape, bool(np.isfinite(out).all())))
    if np.abs(out.sum(axis=1) - 1.0).max() > 1e-4:
        raise RuntimeError("softmax rows do not sum to 1")


def serve_burst(srv, inputs):
    """Submit every input from its own thread at once; every request
    must be answered."""
    reqs = [None] * len(inputs)
    errors = []

    def submit(i):
        try:
            reqs[i] = srv.submit(data=inputs[i], timeout_ms=300000)
        except Exception as e:  # reported below, never swallowed
            errors.append(e)
    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors:
        raise errors[0]
    outs = [r.result(timeout=600)[0] for r in reqs]
    for out, x in zip(outs, inputs):
        check_answer(out, x.shape[0])
    return outs


def forward_ms(model, dev, batch):
    """One eager forward as the server runs it, host dispatch included
    (median of 20, of 50 at batch 1 where the host sets the pace)."""
    x = torch.randn(batch, 3, 224, 224, device=dev)
    return time_ms(lambda: model.run(x), dev, iters=50 if batch == 1
                   else 20, warmup=3, hide_host=False)


def device_profile(model, dev, batch, reps=3):
    """torch.profiler over ``reps`` forwards: device busy share of the
    wall time, the bn_act kernels' share of device time, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    x = torch.randn(batch, 3, 224, 224, device=dev)
    model.run(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model.run(x)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the wrapper's "bn_act.coefs" range shows as a device entry spanning
    # the coefficient kernels: no kernel of its own
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.key != "bn_act.coefs"]
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    mine = sum(k[1] for k in kernels if "bn_act_kernel" in k[0])
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"batch": batch, "wall_ms_per_forward": wall_us / reps / 1e3,
            "device_ms_per_forward": busy / reps / 1e3,
            "device_busy_share": busy / wall_us,
            "bn_act_ms_per_forward": mine / reps / 1e3,
            "top_kernels": [{"name": k[0][:120], "ms_per_forward":
                             k[1] / reps / 1e3, "calls": k[2] // reps}
                            for k in top]}


def main_path(dev, card, report):
    sym = resnet50()
    args, aux = draw_params(sym)
    os.makedirs(os.path.join(REPO, "build", "chip_smoke"), exist_ok=True)
    path = os.path.join(REPO, "build", "chip_smoke", "resnet50.mxtorch")
    t0 = time.perf_counter()
    meta = mt.serving.export_compiled(sym, args, aux,
                                      {"data": (None, 3, 224, 224)}, path,
                                      device=dev)
    log("export: %.2fs, %.1f MB, kernel_tier %s"
        % (time.perf_counter() - t0, os.path.getsize(path) / 1e6,
           json.dumps(meta["kernel_tier"])))
    rng = np.random.RandomState(1)
    inputs = ([rng.randn(1, 3, 224, 224).astype("f4") for _ in range(8)]
              + [rng.randn(8, 3, 224, 224).astype("f4"),
                 rng.randn(32, 3, 224, 224).astype("f4")])

    # -- the main path, with every count zeroed just before it
    tier.reset_stats()
    bn_act.reset_launches()
    srv = mt.serve.Server(path, buckets=BUCKETS, batch_timeout_ms=2)
    outs = serve_burst(srv, inputs)
    # the burst may coalesce into bucket 32 alone: one image and one
    # batch of 8, each sent alone, take buckets 1 and 8
    inputs += [inputs[0], inputs[8]]
    for x in inputs[-2:]:
        outs.append(srv.predict(data=x, timeout_ms=300000)[0])
        check_answer(outs[-1], x.shape[0])
    torch.cuda.synchronize()
    launches = dict(bn_act.launches_by_kernel)
    total = bn_act.launches
    stats = tier.stats()
    est = srv.model.engine_cache.stats()
    forwards = est["builds"] + sum(e["calls"] for e in est["engines"].values())
    log("main path: %d requests answered, %d forwards (engines %s), "
        "launches %s, tier %s" % (len(outs), forwards,
                                  sorted(est["engines"]), launches,
                                  json.dumps(stats["dispatch"])))
    if launches != {"bn_act": 33 * forwards, "bn_act_res": 16 * forwards} \
            or total != 49 * forwards:
        raise RuntimeError("expected 49 launches per forward over %d "
                           "forwards, got %s" % (forwards, launches))
    if stats["fallback"]:
        raise RuntimeError("kernel tier fell back: %s" % stats["fallback"])
    if sorted(est["engines"], key=int) != [str(b) for b in BUCKETS]:
        raise RuntimeError("buckets served: %s, not %s"
                           % (sorted(est["engines"]), list(BUCKETS)))

    # -- the same artifact at tier off on the card
    with mt.config.override(kernel_tier="off"):
        srv_off = mt.serve.Server(path, buckets=BUCKETS, batch_timeout_ms=2)
    off = [srv_off.predict(data=x, timeout_ms=300000)[0] for x in inputs]
    srv_off.close()
    err_off = max(float(np.abs(a - b).max()) for a, b in zip(outs, off))
    log("tier auto vs off on the card: max abs err %g" % err_off)
    if err_off > 1e-5:
        raise RuntimeError("served outputs disagree with tier off")
    if bn_act.launches != total:
        raise RuntimeError("the tier-off server launched the kernel")

    # -- latency per bucket (closed loop, one request in flight)
    lat = {}
    for b in BUCKETS:
        srv.model.engine_cache.engine(b)
        x = np.random.RandomState(b).randn(b, 3, 224, 224).astype("f4")
        samples = []
        t_all = time.perf_counter()
        for _ in range(20):
            t1 = time.perf_counter()
            check_answer(srv.predict(data=x, timeout_ms=300000)[0], b)
            samples.append((time.perf_counter() - t1) * 1e3)
        wall = time.perf_counter() - t_all
        lat[str(b)] = {"p50_ms": float(np.percentile(samples, 50)),
                       "p99_ms": float(np.percentile(samples, 99)),
                       "img_per_s": 20 * b / wall}
        log("bucket %2d: p50 %.3f ms  p99 %.3f ms  %.1f img/s  [%s]"
            % (b, lat[str(b)]["p50_ms"], lat[str(b)]["p99_ms"],
               lat[str(b)]["img_per_s"], card))
    srv.close()

    # -- the batch-32 forward, tier off / auto / auto / off in one call
    with mt.config.override(kernel_tier="off"):
        m_off = mt.serving.CompiledModel.load(path, device=dev)
    m_auto = mt.serving.CompiledModel.load(path, device=dev)
    fwd = {}
    for b in (1, 32):
        f_off1, f_auto1 = forward_ms(m_off, dev, b), forward_ms(m_auto, dev, b)
        f_auto2, f_off2 = forward_ms(m_auto, dev, b), forward_ms(m_off, dev, b)
        fwd[str(b)] = {"auto_ms": [f_auto1, f_auto2],
                       "off_ms": [f_off1, f_off2]}
        log("batch-%d forward: tier auto %.3f / %.3f ms, tier off %.3f / "
            "%.3f ms  [%s]" % (b, f_auto1, f_auto2, f_off1, f_off2, card))
    prof = {}
    for name, m in (("auto", m_auto), ("off", m_off)):
        for b in (1, 32):
            p = device_profile(m, dev, b)
            prof["%s/%d" % (name, b)] = p
            log("profile tier %s batch %d: wall %.3f ms, device %.3f ms "
                "(busy %.1f%%), bn_act %.3f ms; top: %s"
                % (name, b, p["wall_ms_per_forward"],
                   p["device_ms_per_forward"],
                   100 * p["device_busy_share"], p["bn_act_ms_per_forward"],
                   "; ".join("%s %.3f ms x%d" % (k["name"][:48],
                                                k["ms_per_forward"],
                                                k["calls"])
                             for k in p["top_kernels"][:4])))
    # -- one image on the CPU, last: its thread pool must not disturb
    # the timings above
    cpu = mt.serving.CompiledModel.load(path, device="cpu")
    ref = cpu.predict(data=inputs[0])[0].numpy()
    err_cpu = float(np.abs(outs[0] - ref).max())
    log("served on the card vs the CPU (one image): max abs err %g"
        % err_cpu)
    if err_cpu > 1e-5:
        raise RuntimeError("served outputs disagree with the CPU")
    report.update(main_path={"launches": launches, "forwards": forwards,
                             "tier_stats": stats, "engines": est,
                             "err_vs_off": err_off, "err_vs_cpu": err_cpu,
                             "latency": lat, "forward": fwd,
                             "profile": prof,
                             "server": srv.metrics()})
    return launches


# ------------------------------------------------------- decode: kernels
GPT_SPEC = dict(vocab=50257, dim=768, num_heads=12, num_layers=12,
                max_prompt_len=128, page_size=16, max_pages_per_slot=64,
                max_slots=16, num_pages=1025)
GPT_REPLACES = {"take_rows": "mxnet_tpu/kernels/take.py:45",
                "flash_attn": "mxnet_tpu/kernels/attention.py:110",
                "flash_attn_paged": "mxnet_tpu/kernels/attention.py:315"}
GPT_SOURCES = {k: "mxnet_tpu_torch/csrc/%s.cu" % k for k in GPT_REPLACES}
# decode-step positions: 0, page boundaries and a spread up to 1023
DECODE_POSITIONS = [0, 1, 15, 16, 17, 63, 64, 100, 255, 256, 511, 512, 700,
                    900, 1022, 1023]
# the speculative path: bench.py's depth, and a speculative step's 16
# slots at the decode step's positions, the last two moved so that the
# verifier's window of k + 1 rows stays inside the 1024-token context
SPEC_K = 4
VERIFY_POSITIONS = DECODE_POSITIONS[:-2] + [1019 - SPEC_K, 1023 - SPEC_K]


def attn_check(got, want, what):
    """Kernel vs plain: f32 within atol 2e-5, rtol 1e-4 (FMA contraction
    and another summation order); bf16 within one bf16 ulp plus 1e-3.
    Returns the max abs error; raises past the tolerance."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        bad = diff > 2e-5 + 1e-4 * want.float().abs()
    else:
        ulp = torch.maximum(got.float().abs(), want.float().abs()) * 2 ** -7
        bad = diff > ulp + 1e-3
    if bool(bad.any()) or not bool(torch.isfinite(got).all()):
        raise RuntimeError("%s disagrees with its plain version: max abs err "
                           "%g" % (what, float(diff.max())))
    return float(diff.max())


def paged_inputs(dev, dtype, S, W, positions, seed):
    """A (rows, C) K/V store at the slice's geometry, each slot's 64
    pages a random draw of distinct pages 1..1024, queries (S, W, C)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    C, page = GPT_SPEC["dim"], GPT_SPEC["page_size"]
    mp, npages = GPT_SPEC["max_pages_per_slot"], GPT_SPEC["num_pages"]
    kp = torch.randn(npages * page, C, generator=g, device=dev).to(dtype)
    vp = torch.randn(npages * page, C, generator=g, device=dev).to(dtype)
    perm = torch.randperm(npages - 1, generator=g, device=dev) + 1
    bt = perm[:S * mp].reshape(S, mp).to(torch.int32)
    q = torch.randn(S, W, C, generator=g, device=dev).to(dtype)
    pos = torch.tensor(positions, dtype=torch.int32, device=dev)
    return q, kp, vp, bt, pos


def paged_bound(S, W, positions, dtype):
    """(bytes_ms, ops_ms) of one paged call: every visible K and V row
    read once, q read and o written once, the block table and positions;
    4 flops per visible (query row, position, dim) pair."""
    C, page = GPT_SPEC["dim"], GPT_SPEC["page_size"]
    ctx = page * GPT_SPEC["max_pages_per_slot"]
    size = torch.tensor([], dtype=dtype).element_size()
    rows = sum(min(p + W, ctx) for p in positions)
    pairs = sum(min(p + w + 1, ctx) for p in positions for w in range(W))
    nbytes = (2 * rows * C + 2 * S * W * C) * size + S * (
        GPT_SPEC["max_pages_per_slot"] + 1) * 4
    peak = F32_FLOPS if dtype == torch.float32 else BF16_FLOPS
    return nbytes / HBM_BYTES_PER_S * 1e3, 4 * pairs * C / peak * 1e3


def serving_layout(bt, positions, W):
    """The block table as serving writes it: every entry past the page
    of a slot's last visible position lists page 0 (the scratch page)."""
    bt = bt.clone()
    page = GPT_SPEC["page_size"]
    for s, p in enumerate(positions):
        bt[s, (p + W - 1) // page + 1:] = 0
    return bt


def paged_contract_bound(bt, positions, W, dtype):
    """(bytes_ms, ops_ms) of the work the non-finite contract asks of
    one paged call: every store row whose K some query row sees and
    every listed store row's V, each read once however often it is
    listed, q read and o written once, the block table and positions;
    4 flops per visible (query row, position, dim) pair."""
    C, page = GPT_SPEC["dim"], GPT_SPEC["page_size"]
    rows = GPT_SPEC["num_pages"] * page
    S, mp = bt.shape
    size = torch.tensor([], dtype=dtype).element_size()
    ids = (bt.cpu().long()[:, :, None] * page
           + torch.arange(page)).reshape(S, -1).clamp(0, rows - 1)
    krows = torch.cat([ids[s, :max(0, min(p + W, mp * page))]
                       for s, p in enumerate(positions)]).unique().numel()
    vrows = ids.unique().numel()
    nbytes = ((krows + vrows) * C + 2 * S * W * C) * size + S * (mp + 1) * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, paged_bound(
        S, W, positions, dtype)[1]


# the planted non-finite cases (tests/paged_nonfinite.py) at the decode
# step and at a prompt chunk whose last row's page has a masked tail
PLANT_CASES = (("decode", 16, 1, DECODE_POSITIONS), ("chunk", 1, 128, [250]))


def paged_contract_phase(dev):
    """B4 against its plain version on every planted non-finite case, at
    the decode and chunk geometries, f32 and bf16: the plain version's
    NaN and inf masks are the contract's, the kernel's equal them
    exactly, and its finite values are within ``attn_check``'s
    tolerance. -> (cases, max abs err on the finite values)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from paged_nonfinite import CASES, plant
    from mxnet_tpu_torch.kernels import attention as attn
    heads, page = GPT_SPEC["num_heads"], GPT_SPEC["page_size"]
    n, worst = 0, 0.0
    for geom, S, W, positions in PLANT_CASES:
        q, kp, vp, bt, pos = paged_inputs(dev, torch.float32, S, W,
                                          positions, 21)
        host = [t.cpu().numpy() for t in (kp, vp, bt, pos)]
        for case in CASES:
            kpc, vpc, btc, nan, inf = plant(case, *host, W, page)
            for dtype in (torch.float32, torch.bfloat16):
                args = (q.to(dtype), torch.from_numpy(kpc).to(dev, dtype),
                        torch.from_numpy(vpc).to(dev, dtype),
                        torch.from_numpy(btc).to(dev), pos)
                want = attn._plain_paged(*args, heads, page)
                got = attn._launch_paged(*args, heads, page)
                what = "flash_attn_paged %s %s %s" % (geom, case, dtype)
                if not (torch.equal(torch.isnan(want).cpu(),
                                    torch.from_numpy(nan))
                        and torch.equal(torch.isinf(want).cpu(),
                                        torch.from_numpy(inf))):
                    raise RuntimeError("%s: the plain version's NaN/inf "
                                       "masks are not the contract's" % what)
                for test in (torch.isnan, torch.isposinf, torch.isneginf):
                    if not torch.equal(test(got), test(want)):
                        raise RuntimeError("%s: %s masks differ (kernel %d, "
                                           "plain %d)" % (
                                               what, test.__name__,
                                               int(test(got).sum()),
                                               int(test(want).sum())))
                fin = torch.isfinite(want)
                worst = max(worst, attn_check(got[fin], want[fin], what))
                n += 1
    log("flash_attn_paged on %d planted non-finite cases (%s x %s, f32 and "
        "bf16): NaN/inf masks equal the plain version's and the contract's, "
        "finite values max abs err %g" % (
            n, "/".join(g for g, *_ in PLANT_CASES), "/".join(CASES), worst))
    return n, worst


def gpt_kernel_phase(dev):
    """B2, B3 and B4 against their plain versions at the slice's shapes,
    f32 and bf16, then their times (f32) beside plain, library, bound."""
    from mxnet_tpu_torch.kernels import attention as attn
    from mxnet_tpu_torch.kernels import take
    F = torch.nn.functional
    err, rows = {}, {}
    # -- B2 take_rows: (16400, 768) table, (16, 1024) ids, some out of range
    C = GPT_SPEC["dim"]
    R = GPT_SPEC["num_pages"] * GPT_SPEC["page_size"]
    g = torch.Generator(device=dev).manual_seed(11)
    ids = torch.randint(-300, R + 300, (16, 1024), generator=g, device=dev,
                        dtype=torch.int32)
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.randn(R, C, generator=g, device=dev).to(dtype)
        got = take.take_rows(table, ids)
        want = take._plain_take(table, ids)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError("take_rows is not bitwise the clipped gather "
                               "(%s)" % dtype)
        err["take_rows/" + str(dtype)[6:]] = 0.0
    table = torch.randn(R, C, generator=g, device=dev)
    flat = ids.reshape(-1).contiguous()
    clipped = ids.long().clamp(0, R - 1).reshape(-1)
    nbytes = 2 * flat.numel() * C * 4 + flat.numel() * 4
    rows["take_rows"] = {
        "shape": "table (%d, %d) f32, ids (16, 1024)" % (R, C),
        "ms": time_ms(lambda: take._launch(table, flat,
                                           take.DEFAULT_CONFIG), dev),
        "plain_ms": time_ms(lambda: take._plain_take(table, ids), dev),
        "library_ms": time_ms(lambda: torch.index_select(table, 0, clipped),
                              dev),
        "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3, "ops_ms": 0.0}
    # -- B3 flash_attn: prefill (16, 12, 128, 64) causal, and T = 100 at
    # head dims 64, 32 and 128
    for shape in ((16, 12, 128, 64), (2, 12, 100, 64), (2, 12, 100, 32),
                  (2, 6, 100, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(shape, generator=g, device=dev).to(dtype)
                       for _ in range(3))
            got = attn._launch_flash(q, k, v, True)
            e = attn_check(got, attn._plain_flash(q, k, v, True),
                           "flash_attn %s %s" % (shape, dtype))
            key = "flash_attn/" + str(dtype)[6:]
            err[key] = max(err.get(key, 0.0), e)
    shape = (16, 12, 128, 64)
    q, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    B, H, T, D = shape
    bytes_ms, ops_ms, core_ms = flash_bound_parts(
        q, B * H * T * (T + 1) // 2)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    rows["flash_attn"] = {
        "shape": "(16, 12, 128, 64) f32 causal",
        "ms": time_ms(lambda: attn._launch_flash(q, k, v, True), dev),
        "plain_ms": time_ms(lambda: attn._plain_flash(q, k, v, True), dev),
        "library_ms": time_ms(sdpa, dev), "library_kernel": device_kernels(
            sdpa), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "core_ops_ms": core_ms}
    # -- B4 flash_attn_paged: decode (S=16, W=1) and chunks (S=1, W=128)
    cases = [(16, 1, DECODE_POSITIONS), (1, 128, [0]), (1, 128, [256])]
    for S, W, positions in cases:
        for dtype in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, pos = paged_inputs(dev, dtype, S, W, positions,
                                              S + W)
            got = attn._launch_paged(q, kp, vp, bt, pos, 12, 16)
            e = attn_check(got, attn._plain_paged(q, kp, vp, bt, pos, 12,
                                                  16),
                           "flash_attn_paged S=%d W=%d %s" % (S, W, dtype))
            key = "flash_attn_paged/" + str(dtype)[6:]
            err[key] = max(err.get(key, 0.0), e)
    # the speculative verifier's window, W = k + 1, held apart from the
    # generate path's shapes
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, pos = paged_inputs(dev, dtype, 16, SPEC_K + 1,
                                          VERIFY_POSITIONS, 5)
        got = attn._launch_paged(q, kp, vp, bt, pos, 12, 16)
        err["flash_attn_paged@verify/" + str(dtype)[6:]] = attn_check(
            got, attn._plain_paged(q, kp, vp, bt, pos, 12, 16),
            "flash_attn_paged S=16 W=%d %s" % (SPEC_K + 1, dtype))
    err["flash_attn_paged/planted"] = paged_contract_phase(dev)[1]
    # the layouts: 64 distinct pages a slot (every entry listed), and the
    # serving one (unused entries page 0); bound_ms is the contract's
    # work, visible_bound_ms the visible rows' alone (the earlier bound)
    # and the longest slot alone (12 CTAs of 64 pages): what one CTA
    # streams, the time no grid of one CTA per (slot, head) goes below
    for name, (S, W, positions), layout in (
            ("flash_attn_paged", cases[0], "distinct"),
            ("flash_attn_paged/serving", cases[0], "serving"),
            ("flash_attn_paged/chunk@256", cases[2], "distinct"),
            ("flash_attn_paged/one-slot@1023", (1, 1, [1023]), "distinct"),
            ("flash_attn_paged/verify", (16, SPEC_K + 1, VERIFY_POSITIONS),
             "distinct"),
            ("flash_attn_paged/verify-serving",
             (16, SPEC_K + 1, VERIFY_POSITIONS), "serving")):
        q, kp, vp, bt, pos = paged_inputs(dev, torch.float32, S, W,
                                          positions, 3)
        if layout == "serving":
            bt = serving_layout(bt, positions, W)
        bytes_ms, ops_ms = paged_contract_bound(bt, positions, W,
                                                torch.float32)
        rows[name] = {
            "shape": "S=%d W=%d f32 at positions %s, %s pages" % (
                S, W, positions, layout),
            "ms": time_ms(lambda: attn._launch_paged(q, kp, vp, bt, pos, 12,
                                                     16), dev),
            "plain_ms": time_ms(lambda: attn._plain_paged(
                q, kp, vp, bt, pos, 12, 16), dev),
            "ms_clean_l2": time_ms(lambda: attn._launch_paged(
                q, kp, vp, bt, pos, 12, 16), dev, clean_l2=True),
            "library_ms": None, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "visible_bound_ms": bound_of(*paged_bound(
                S, W, positions, torch.float32))[0]}
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound_of(r["bytes_ms"], r["ops_ms"])
        log("  %-28s %-44s ms=%.5f plain_ms=%.5f library_ms=%s "
            "bound_ms=%.5f (%s)" % (name, r["shape"], r["ms"], r["plain_ms"],
                                    "%.5f" % r["library_ms"]
                                    if r["library_ms"] is not None
                                    else "none", r["bound_ms"],
                                    r["bound_by"]))
    log_flash_bound("flash_attn", rows["flash_attn"])
    for name in ("flash_attn_paged", "flash_attn_paged/serving",
                 "flash_attn_paged/chunk@256",
                 "flash_attn_paged/one-slot@1023", "flash_attn_paged/verify",
                 "flash_attn_paged/verify-serving"):
        log("  %-28s contract bound %.5f ms, visible-row bound %.5f ms; "
            "%.5f ms after a flush that leaves L2 clean" % (
                name, rows[name]["bound_ms"], rows[name]["visible_bound_ms"],
                rows[name]["ms_clean_l2"]))
    log("decode kernels vs plain (f32 and bf16): max abs err %s"
        % json.dumps(err))
    return err, rows


# ---------------------------------------------------- decode: main path
def gpt_traffic():
    """24 requests from RandomState(0): 22 prompts of 8-128 tokens and 2
    of 300-400 (chunked prefill), 32-96 new tokens each, every third
    sampled at temperature 0.8 with its own seed, the rest greedy."""
    rng = np.random.RandomState(0)
    V = GPT_SPEC["vocab"]
    work = []
    for i in range(24):
        n = int(rng.randint(300, 401)) if i in (5, 17) else int(
            rng.randint(8, 129))
        prompt = rng.randint(0, V, n).tolist()
        sampled = i % 3 == 2
        work.append((prompt, int(rng.randint(32, 97)),
                     0.8 if sampled else 0.0, 1000 + i if sampled else 0))
    return work


def serve_all(srv, work):
    """Submit every request at once; every one must finish with its
    full token budget ("length": the spec has no stop token)."""
    reqs = [srv.submit_generate(p, max_new_tokens=n, temperature=t, seed=s,
                                timeout_ms=0) for p, n, t, s in work]
    outs = [r.result(timeout=900) for r in reqs]
    for o, (p, n, _t, _s) in zip(outs, work):
        if len(o["tokens"]) != n or o["finish_reason"] != "length":
            raise RuntimeError("request of %d prompt tokens got %d of %d "
                               "tokens, finish %r" % (len(p), len(o["tokens"]),
                                                      n, o["finish_reason"]))
    return outs


def replay_logits(params, spec, seqs, dev):
    """Teacher-forced logits of each full sequence through the paged
    path (chunk_prefill, logits of every row) under the tier in force;
    row j predicts position j + 1."""
    from mxnet_tpu_torch.serve import decode_model as dm
    fn = dm.make_chunk_prefill(params, spec, logits=True)
    P, page = spec.max_prompt_len, spec.page_size
    shape = (spec.num_layers, (spec.max_pages_per_slot + 1) * page,
             spec.dim)
    k = torch.zeros(shape, device=dev)
    v = torch.zeros(shape, device=dev)
    bt = torch.arange(1, spec.max_pages_per_slot + 1, dtype=torch.int32,
                      device=dev)
    out = []
    for seq in seqs:
        parts = []
        for start in range(0, len(seq), P):
            chunk = np.zeros(P, np.int32)
            c = seq[start:start + P]
            chunk[:len(c)] = c
            lg, _k, _v = fn(chunk, start, len(c), bt, 0.0, 0, k, v)
            parts.append(lg[:len(c)])
        out.append(torch.cat(parts))
    return out


def z_margins(logits, temps, seeds, pos):
    """Top-1/top-2 margin of what ``_sample`` takes the argmax of at
    each (slot, row): the logits when greedy, Gumbel noise under the
    slot's key at the sampled position + logits / t when sampling.
    logits (S, n, V), pos (S, n) -> (S, n)."""
    from mxnet_tpu_torch.serve import _threefry
    S, n, V = logits.shape
    lg = logits.float().reshape(S * n, V)
    t = torch.as_tensor(np.repeat(temps, n), device=lg.device)
    key = _threefry.fold_in(_threefry.fold_in(
        _threefry.prng_key(0, lg.device),
        torch.as_tensor(np.repeat(seeds, n).astype(np.int64),
                        device=lg.device)),
        torch.as_tensor(pos.reshape(-1).astype(np.int64), device=lg.device))
    z = torch.where(t[:, None] > 0,
                    _threefry.gumbel(key, V) + lg / t.clamp_min(1e-6)[:, None],
                    lg)
    top2 = torch.topk(z, 2, dim=1).values
    return (top2[:, 0] - top2[:, 1]).reshape(S, n).cpu().numpy()


def margin_compare(name, work, got, want, plain_logits, auto_logits):
    """Tokens equal up to the first position where the plain run's
    top-1/top-2 margin (of gumbel + logits / t when sampling, with the
    request's key) is below 1e-4; there the two paths' logits must
    agree within 1e-4. -> number of sequences stopped early."""
    stopped = 0
    for i, ((prompt, n, t, seed), a, b) in enumerate(zip(work, got, want)):
        lp = len(prompt)
        margin = z_margins(plain_logits[i][None, lp - 1:lp - 1 + n],
                           np.array([t], np.float32), np.array([seed]),
                           np.arange(lp, lp + n)[None])[0]
        low = np.nonzero(margin < 1e-4)[0]
        stop = int(low[0]) if len(low) else n
        if a[:stop] != b[:stop]:
            j = next(j for j in range(stop) if a[j] != b[j])
            raise RuntimeError("%s: request %d differs at token %d (margin "
                               "%g)" % (name, i, j, margin[j]))
        if stop < n:
            stopped += 1
            d = float((auto_logits[i][lp - 1 + stop]
                       - plain_logits[i][lp - 1 + stop]).abs().max())
            log("  %s: request %d stops at token %d of %d (margin %g), "
                "logits there differ by %g" % (name, i, stop, n,
                                               margin[stop], d))
            if d > 1e-4:
                raise RuntimeError("%s: logits differ by %g at request %d "
                                   "token %d" % (name, d, i, stop))
    log("%s: %d sequences compared, %d stopped early at a near tie"
        % (name, len(work), stopped))
    if stopped * 8 > len(work):
        raise RuntimeError("%s: %d of %d sequences stopped early"
                           % (name, stopped, len(work)))
    return stopped


def profile_steps(step, n_wall, steps=5, parts=()):
    """Steps as the session runs them: wall ms per step over ``n_wall``
    calls of ``step`` (after 3 warm-up calls), then torch.profiler over
    ``steps`` more: device ms a step and busy share, the top kernels and
    host ops (self time, the profiler's own cost included), and for each
    ``(key, substrings)`` of ``parts`` the device ms a step of the
    kernels whose names hold one of the substrings."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        step()
    t0 = time.perf_counter()
    for _ in range(n_wall):
        step()
    step_ms = (time.perf_counter() - t0) / n_wall * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    kernels = [(e.key, e.self_device_time_total, e.count) for e in events
               if e.device_type == DeviceType.CUDA]
    busy = sum(x[1] for x in kernels)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    host = [(e.key, e.self_cpu_time_total, e.count) for e in events
            if e.device_type == DeviceType.CPU]

    def top(rows, n):
        return [{"name": x[0][:100], "ms_per_step": x[1] / steps / 1e3,
                 "calls": x[2] // steps}
                for x in sorted(rows, key=lambda x: -x[1])[:n]]
    out = {"step_ms": step_ms, "profiled_wall_ms": wall_us / steps / 1e3,
           "device_ms": busy / steps / 1e3,
           "device_busy_share": busy / wall_us,
           "kernel_launches": sum(x[2] for x in kernels) / steps,
           "top_kernels": top(kernels, 8), "top_host_ops": top(host, 8)}
    for key, subs in parts:
        out[key] = sum(x[1] for x in kernels if any(
            n in x[0].lower() for n in subs)) / steps / 1e3
    return out


def decode_step_profile(model, spec, dev, steps=5):
    """Decode steps as the session runs them (16 live slots, host inputs,
    one device-to-host copy each), ``profile_steps`` over 20 and
    ``steps`` steps."""
    S, mp = spec.max_slots, spec.max_pages_per_slot
    shape = (spec.num_layers, spec.cache_rows, spec.dim)
    k = torch.zeros(shape, device=dev)
    v = torch.zeros(shape, device=dev)
    bt = (np.arange(S * mp, dtype=np.int32) % (spec.num_pages - 1)
          + 1).reshape(S, mp)
    pos = np.array(DECODE_POSITIONS, np.int32)
    args = (np.ones((S, 1), np.int32), pos, bt, np.zeros(S, np.float32),
            np.zeros(S, np.int32))

    def step():
        nxt, _k, _v = model.decode(*args, k, v)
        return nxt.cpu()
    return profile_steps(step, 20, steps,
                         parts=(("paged_ms", ("flash_attn_paged",)),))


def gpt_main_path(dev, card, report):
    from mxnet_tpu_torch.kernels import attention as attn
    from mxnet_tpu_torch.kernels import take
    from mxnet_tpu_torch.serve import decode_model as dm
    spec = dm.DecoderSpec(**GPT_SPEC)
    t0 = time.perf_counter()
    params = dm.init_params(spec, seed=0)
    path = os.path.join(REPO, "build", "chip_smoke", "gpt2s.mxtorch")
    meta = mt.serving.export_generate(params, spec, path, chunked=True)
    del params
    log("decoder at GPT-2-small widths (%s): %.1f M f32 parameters, "
        "KV cache %.2f GB, export %.1fs, kernel_tier %s"
        % (json.dumps(GPT_SPEC), os.path.getsize(path) / 4e6,
           spec.cache_bytes() / 1e9, time.perf_counter() - t0,
           json.dumps(meta["kernel_tier"])))
    work = gpt_traffic()
    cfg = dict(timeout_ms=0, queue_depth=64)

    # -- the main path, with every count zeroed just before it
    tier.reset_stats()
    attn.reset_launches()
    take.reset_launches()
    t0 = time.perf_counter()
    srv = mt.serve.Server(path, config=mt.serve.GenerateConfig(**cfg),
                          device=dev)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = serve_all(srv, work)
    wall_s = time.perf_counter() - t0
    srv.close()
    torch.cuda.synchronize()
    launches = dict(attn.launches_by_kernel, take_rows=take.launches)
    stats = tier.stats()
    snap = srv.metrics()
    est = snap["engines"]
    prefill_runs = est["builds"] + sum(e["calls"]
                                       for e in est["engines"].values())
    P = spec.max_prompt_len
    chunks = sum(-(-len(p) // P) for p, _n, _t, _s in work if len(p) > P)
    steps = snap["decode_steps"]
    L = spec.num_layers
    want = {"flash_attn": L * prefill_runs,
            "flash_attn_paged": L * (steps + chunks + 2), "take_rows": 0}
    log("generate path: %d requests, %d tokens in %.2fs after %.1fs of "
        "setup; %d prefill runs (%d groups + warmups), %d chunks, %d decode "
        "steps (+1 warmup step, +1 warmup chunk); launches %s; tier %s"
        % (len(outs), sum(len(o["tokens"]) for o in outs), wall_s, setup_s,
           prefill_runs, snap["prefill"]["batches"], chunks, steps,
           launches, json.dumps(stats["dispatch"])))
    log("take_rows launches on the main path: %d (the paged kernel serves "
        "every attention site at this geometry)" % launches["take_rows"])
    if stats["fallback"]:
        raise RuntimeError("kernel tier fell back: %s" % stats["fallback"])
    if launches != want or any(stats["dispatch"].get(k, 0) != n
                               for k, n in want.items()):
        raise RuntimeError("launches %s and dispatches %s, expected %s"
                           % (launches, stats["dispatch"], want))
    req = snap["requests"]
    if req["completed"] != len(work) or req["evicted"] or req["rejected"]:
        raise RuntimeError("requests: %s" % req)
    tokens = [o["tokens"] for o in outs]
    model = srv.model
    del srv

    # -- the same artifact at tier off on the card, and the references
    with mt.config.override(kernel_tier="off"):
        srv_off = mt.serve.Server(path, config=mt.serve.GenerateConfig(
            **cfg), device=dev)
    off = [o["tokens"] for o in serve_all(srv_off, work)]
    model_off = srv_off.model
    srv_off.close()
    del srv_off
    seqs = [p + t for (p, _n, _t, _s), t in zip(work, off)]
    with mt.config.override(kernel_tier="off"):
        plain_logits = replay_logits(model_off.params, spec, seqs, dev)
    auto_logits = replay_logits(model.params, spec, seqs, dev)
    stopped = margin_compare("tier auto vs off", work, tokens, off,
                             plain_logits, auto_logits)
    greedy = [i for i, w in enumerate(work) if w[2] == 0][:4]
    ref = [dm.reference_generate(model.params, spec, work[i][0], work[i][1])
           for i in greedy]
    stopped_ref = margin_compare(
        "tier auto vs reference_generate", [work[i] for i in greedy],
        [tokens[i] for i in greedy], ref,
        [plain_logits[i] for i in greedy], [auto_logits[i] for i in greedy])

    # -- latency, throughput and the decode step on the card
    prof = decode_step_profile(model, spec, dev)
    gen = sum(len(t) for t in tokens)
    perf = {"ttft_ms": snap["ttft_ms"], "tpot_ms": snap["tpot_ms"],
            "tokens_per_s": gen / wall_s, "decode_step": prof}
    log("TTFT p50 %.2f ms p99 %.2f ms, TPOT p50 %.2f ms p99 %.2f ms, "
        "%.1f generated tokens/s  [%s]"
        % (snap["ttft_ms"]["p50"], snap["ttft_ms"]["p99"],
           snap["tpot_ms"]["p50"], snap["tpot_ms"]["p99"], gen / wall_s,
           card))
    log("decode step (16 live slots): %.2f ms wall; profiled %.2f ms wall, "
        "%.3f ms device (busy %.1f%%), flash_attn_paged %.3f ms; top: %s  "
        "[%s]" % (prof["step_ms"], prof["profiled_wall_ms"],
                  prof["device_ms"], 100 * prof["device_busy_share"],
                  prof["paged_ms"], "; ".join(
                      "%s %.3f ms x%d" % (k["name"][:40], k["ms_per_step"],
                                          k["calls"])
                      for k in prof["top_kernels"][:4]), card))
    report.update(generate={"launches": launches, "tier_stats": stats,
                            "metrics": snap, "stopped_early": stopped,
                            "stopped_early_ref": stopped_ref,
                            "perf": perf})
    # what the speculative path is held and measured against
    plain = {"work": work, "tokens": tokens, "off": off,
             "plain_logits": plain_logits, "auto_logits": auto_logits,
             "snap": snap, "wall_s": wall_s, "step": prof}
    return launches, plain


# ----------------------------------------- decode: the speculative path
def spec_state(model, work, dev):
    """A speculative step's slot state from real prompts: the first 16
    requests' prompts prefilled through ``chunk_prefill`` (verifier
    cache, f32) and ``draft_chunk_prefill`` (draft cache, int8), slot s
    owning pages 64s+1 .. 64s+64. -> (args, [k, v, dk, dv])."""
    spec = model.spec
    S, mp, P = spec.max_slots, spec.max_pages_per_slot, spec.max_prompt_len
    shape = (spec.num_layers, spec.cache_rows, spec.dim)
    caches = [torch.zeros(shape, device=dev) for _ in range(4)]
    bt = (np.arange(S * mp, dtype=np.int32) + 1).reshape(S, mp)
    tokens = np.zeros((S, 1), np.int32)
    positions = np.zeros(S, np.int32)
    temps = np.zeros(S, np.float32)
    seeds = np.zeros(S, np.int32)
    for s, (prompt, _n, t, seed) in enumerate(work[:S]):
        for start in range(0, len(prompt), P):
            part = prompt[start:start + P]
            toks = np.zeros(P, np.int32)
            toks[:len(part)] = part
            args = (toks, start, len(part), bt[s], t, seed)
            nxt, _k, _v = model.chunk_prefill(*args, caches[0], caches[1])
            model.draft_chunk_prefill(*args, caches[2], caches[3])
        tokens[s, 0], positions[s] = int(nxt), len(prompt)
        temps[s], seeds[s] = t, seed
    return (tokens, positions, bt, temps, seeds), caches


def draft_verify_tiers(model, spec, state):
    """One speculative step at tier auto and at tier off from the same
    slot state. Draft proposal j, verifier token j + 1 and n_accept must
    be equal up to the first row whose draft or verifier margin (of the
    tier-off logits, ``z_margins``) is below 1e-4; no more than 1 slot
    in 8 may stop early. -> summary dict."""
    from mxnet_tpu_torch.serve import decode_model as dm
    args, caches = state
    out = {}
    for tier_val in ("auto", "off"):
        with mt.config.override(kernel_tier=tier_val):
            fn = dm.make_draft_verify(model.params, model.draft_params, spec,
                                      SPEC_K, logits=True)
        packed, props, dlg, vlg = fn(*args, *[c.clone() for c in caches])
        out[tier_val] = (packed.cpu().numpy(), props.cpu().numpy(), dlg, vlg)
    _tokens, positions, _bt, temps, seeds = args
    pa, ra, _dla, vla = out["auto"]
    po, ro, dlo, vlo = out["off"]
    W = SPEC_K + 1
    pos = positions[:, None] + np.arange(W)[None, :] + 1     # sampled at
    md = z_margins(dlo, temps, seeds, pos[:, :SPEC_K])
    mv = z_margins(vlo, temps, seeds, pos)
    stopped, logit_err = 0, 0.0
    for s in range(spec.max_slots):
        low = [j for j in range(W) if mv[s, j] < 1e-4
               or (j < SPEC_K and md[s, j] < 1e-4)]
        f = low[0] if low else W
        same = (np.array_equal(ra[s, :f], ro[s, :f])
                and np.array_equal(pa[s, 1:1 + f], po[s, 1:1 + f])
                and (pa[s, 0] == po[s, 0] or po[s, 0] >= f))
        if not same:
            raise RuntimeError(
                "draft_verify tier auto vs off: slot %d differs before its "
                "first near tie (row %d): packed %s vs %s, proposals %s vs "
                "%s" % (s, f, pa[s].tolist(), po[s].tolist(),
                        ra[s].tolist(), ro[s].tolist()))
        if f < W:
            stopped += 1
            log("  draft_verify: slot %d stops at row %d (draft margin %s, "
                "verifier margin %g)" % (s, f, md[s, f] if f < SPEC_K
                                         else None, mv[s, f]))
        if f:
            logit_err = max(logit_err, float(
                (vla[s, :f] - vlo[s, :f]).abs().max()))
    if stopped * 8 > spec.max_slots:
        raise RuntimeError("draft_verify tier auto vs off: %d of %d slots "
                           "stopped early" % (stopped, spec.max_slots))
    summary = {"n_accept_auto": pa[:, 0].tolist(),
               "n_accept_off": po[:, 0].tolist(),
               "stopped_early": stopped,
               "verifier_logits_max_abs_diff": logit_err,
               "min_draft_margin": float(md.min()),
               "min_verifier_margin": float(mv.min())}
    log("draft_verify tier auto vs off on %d prefilled slots: packed equal "
        "up to near ties (%d slots stopped early); n_accept auto %s, off %s; "
        "verifier logits within %g before the first tie"
        % (spec.max_slots, stopped, summary["n_accept_auto"],
           summary["n_accept_off"], logit_err))
    return summary


def spec_step_profile(model, state, steps=5):
    """Speculative steps as the session runs them (16 live slots, host
    inputs, one device-to-host copy of ``packed`` each) from the same
    slot state, ``profile_steps`` over 10 and ``steps`` steps; the int8
    GEMMs are the cuBLASLt kernels with an int8 type in their names."""
    args, caches = state

    def step():
        packed, _k, _v, _dk, _dv = model.draft_verify(*args, *caches)
        return packed.cpu()
    return profile_steps(step, 10, steps, parts=(
        ("paged_ms", ("flash_attn_paged",)),
        ("int8_gemm_ms", ("imma", "i8", "int8", "s8"))))


def spec_main_path(dev, card, report, plain):
    """The speculative path: the same GPT-2-small weights exported with
    their int8 draft (depth SPEC_K, as bench.py's decode leg) and served
    with draft="on" to the generate path's traffic."""
    from mxnet_tpu_torch.kernels import attention as attn
    from mxnet_tpu_torch.kernels import take
    from mxnet_tpu_torch.serve import decode_model as dm
    spec = dm.DecoderSpec(**GPT_SPEC)
    t0 = time.perf_counter()
    params = dm.init_params(spec, seed=0)
    draft = dm.quantize_decoder_params(params)
    q_bytes = sum(v.nbytes for n, v in draft.items() if n.endswith("_q"))
    f_bytes = sum(params[n[:-2]].nbytes for n in draft if n.endswith("_q"))
    path = os.path.join(REPO, "build", "chip_smoke", "gpt2s.spec.mxtorch")
    meta = mt.serving.export_generate(params, spec, path, draft_params=draft,
                                      speculate_k=SPEC_K)
    del params, draft
    suggested = dm.suggest_speculation_depth(spec)
    log("speculative artifact: int8 draft weights %.1f MB against %.1f MB "
        "in f32 (%.3fx), export %.1fs, speculate_k %d (the roofline pick on "
        "the H100's rates: %d), kernel_tier %s"
        % (q_bytes / 1e6, f_bytes / 1e6, q_bytes / f_bytes,
           time.perf_counter() - t0, meta["generate"]["speculate_k"],
           suggested, json.dumps(meta["kernel_tier"]["kernels"])))
    work = plain["work"]
    cfg = dict(timeout_ms=0, queue_depth=64)

    # -- the main path, with every count zeroed just before it
    tier.reset_stats()
    attn.reset_launches()
    take.reset_launches()
    t0 = time.perf_counter()
    srv = mt.serve.Server(path, config=mt.serve.GenerateConfig(**cfg),
                          device=dev, draft="on")
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs = serve_all(srv, work)
    wall_s = time.perf_counter() - t0
    srv.close()
    torch.cuda.synchronize()
    launches = dict(attn.launches_by_kernel, take_rows=take.launches)
    stats = tier.stats()
    snap = srv.metrics()
    if not srv.session.speculative or srv.session.speculate_k != SPEC_K:
        raise RuntimeError("the session does not speculate at depth %d"
                           % SPEC_K)
    est = snap["engines"]
    prefill_runs = est["builds"] + sum(e["calls"]
                                       for e in est["engines"].values())
    P, L = spec.max_prompt_len, spec.num_layers
    chunks = sum(-(-len(p) // P) for p, _n, _t, _s in work if len(p) > P)
    draft_chunks = sum(-(-len(p) // P) for p, _n, _t, _s in work)
    steps = snap["decode_steps"]
    # warmup: a decode step, a chunk, a draft chunk and a speculative
    # step; then every step's k draft token-steps and its verifier, the
    # long prompts' chunks and every prompt's draft chunks
    want = {"flash_attn": L * prefill_runs,
            "flash_attn_paged": L * (SPEC_K + 1) * (steps + 1)
            + L * (chunks + draft_chunks + 3), "take_rows": 0}
    log("speculative path: %d requests, %d tokens in %.2fs after %.1fs of "
        "setup; %d prefill runs, %d chunks, %d draft chunks, %d speculative "
        "steps (+1 warmup); launches %s; tier %s"
        % (len(outs), sum(len(o["tokens"]) for o in outs), wall_s, setup_s,
           prefill_runs, chunks, draft_chunks, steps, launches,
           json.dumps(stats["dispatch"])))
    if stats["fallback"]:
        raise RuntimeError("kernel tier fell back: %s" % stats["fallback"])
    if launches != want or any(stats["dispatch"].get(k, 0) != n
                               for k, n in want.items()):
        raise RuntimeError("launches %s and dispatches %s, expected %s"
                           % (launches, stats["dispatch"], want))
    req = snap["requests"]
    if req["completed"] != len(work) or req["evicted"] or req["rejected"]:
        raise RuntimeError("requests: %s" % req)
    tokens = [o["tokens"] for o in outs]
    stopped = {
        "vs tier off": margin_compare(
            "speculative vs plain at tier off", work, tokens, plain["off"],
            plain["plain_logits"], plain["auto_logits"]),
        "vs tier auto": margin_compare(
            "speculative vs plain at tier auto", work, tokens,
            plain["tokens"], plain["plain_logits"], plain["auto_logits"])}

    # -- acceptance: the draft's own check, so it is held
    acc = [(o["accepted_tokens_per_step"], o["draft_acceptance_rate"])
           for o in outs]
    greedy = [a for (a, _r), w in zip(acc, work) if w[2] == 0]
    if not any(a > 1.0 for a in greedy):
        raise RuntimeError("no greedy request accepted a draft token: %s"
                           % greedy)
    sp = snap["speculative"]
    log("acceptance: accepted_tokens_per_step %s, draft_acceptance_rate %s "
        "over %d slot-steps (k %d); per request (greedy / sampled at 0.8): "
        "%s" % (sp["accepted_tokens_per_step"], sp["draft_acceptance_rate"],
                sp["steps"], sp["k"], "; ".join(
                    "%.2f/%.2f%s" % (a, r, "s" if w[2] > 0 else "")
                    for (a, r), w in zip(acc, work))))
    model = srv.model
    del srv
    state = spec_state(model, work, dev)
    tiers = draft_verify_tiers(model, spec, state)

    # -- latency, throughput and the speculative step on the card
    prof = spec_step_profile(model, state)
    del state
    gen = sum(len(t) for t in tokens)
    ps = plain["snap"]
    perf = {"ttft_ms": snap["ttft_ms"], "tpot_ms": snap["tpot_ms"],
            "tokens_per_s": gen / wall_s, "spec_step": prof,
            "plain": {"ttft_ms": ps["ttft_ms"], "tpot_ms": ps["tpot_ms"],
                      "tokens_per_s": gen / plain["wall_s"],
                      "decode_step": plain["step"]}}
    for name, sn, tps in (("speculation on ", snap, gen / wall_s),
                          ("speculation off", ps, gen / plain["wall_s"])):
        log("%s: TTFT p50 %.2f ms p99 %.2f ms, TPOT p50 %.2f ms p99 %.2f "
            "ms, %.1f generated tokens/s  [%s]"
            % (name, sn["ttft_ms"]["p50"], sn["ttft_ms"]["p99"],
               sn["tpot_ms"]["p50"], sn["tpot_ms"]["p99"], tps, card))
    log("speculative step (16 live slots, k %d): %.2f ms wall; profiled "
        "%.2f ms wall, %.3f ms device (busy %.1f%%), flash_attn_paged %.3f "
        "ms, int8 GEMMs %.3f ms; top: %s  [%s]"
        % (SPEC_K, prof["step_ms"], prof["profiled_wall_ms"],
           prof["device_ms"], 100 * prof["device_busy_share"],
           prof["paged_ms"], prof["int8_gemm_ms"], "; ".join(
               "%s %.3f ms x%d" % (k["name"][:40], k["ms_per_step"],
                                   k["calls"])
               for k in prof["top_kernels"][:5]), card))
    log("  host time by op (self, profiled): %s" % "; ".join(
        "%s %.2f ms x%d" % (k["name"], k["ms_per_step"], k["calls"])
        for k in prof["top_host_ops"]))
    report.update(speculative={
        "launches": launches, "tier_stats": stats, "metrics": snap,
        "stopped_early": stopped, "draft_verify_tiers": tiers,
        "acceptance": acc, "suggested_k": suggested,
        "draft_weight_bytes": q_bytes, "f32_weight_bytes": f_bytes,
        "perf": perf})
    return launches


# -------------------------------------------------- training: kernels
GPT_TRAIN = dict(vocab=50257, dim=768, heads=12, layers=12, seq_len=1024,
                 batch=8, lag=17)
TRAIN_REPLACES = {"scale_bias_act": "mxnet_tpu/kernels/mlp.py:53",
                  "flash_fwd": "mxnet_tpu/ops/pallas_flash.py:35"}
TRAIN_SOURCES = {k: "mxnet_tpu_torch/csrc/%s.cu" % k for k in TRAIN_REPLACES}
TIME_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
# the flash rows also name the library call's device kernel
NAMED_KEYS = TIME_KEYS + ("library_kernel", "visible_bound_ms",
                          "ms_clean_l2")
# phase 7's shapes: the MLP up-projection and a ragged one; the attention
# shape, causal and not, causal cross-length (tq > tk: rows that see no
# key) and a ragged T; the token-embedding table and its ids
B5_SHAPES = ((8192, 3072), (1000, 3000))
ATTN_SHAPE = (8, 12, 1024, 64)
B7_CASES = ((ATTN_SHAPE, 1024, True), (ATTN_SHAPE, 1024, False),
            ((1, 2, 100, 64), 60, True), ((2, 12, 100, 64), 100, True),
            ((2, 12, 100, 32), 100, True), ((1, 4, 256, 128), 256, False))
EMBED = ((50257, 768), (8, 1024))


def grads_of(fn, inputs, cot):
    """(out, grads) of sum(fn(*inputs) * cot) for the float inputs."""
    leaves = [None if t is None else t.detach().clone().requires_grad_(
        t.is_floating_point()) for t in inputs]
    out = fn(*leaves)
    (out.float() * cot).sum().backward()
    return out.detach(), [None if t is None or not t.is_floating_point()
                          else t.grad for t in leaves]


def grad_check(got, want, what):
    """Gradients: f32 within atol 2e-5, rtol 1e-4. bf16: a gradient
    element is a sum of up to T products whose factors each path rounds
    to bf16 in other places, so single elements may differ by several
    ulps of the largest term; the check is the relative L2 error, within
    one bf16 ulp (2^-7). Returns the max abs error; raises past it."""
    diff = (got.float() - want.float()).abs()
    if got.dtype == torch.float32:
        bad = bool((diff > 2e-5 + 1e-4 * want.float().abs()).any())
    else:
        bad = float(diff.norm()) > 2 ** -7 * float(want.float().norm())
    if bad or not bool(torch.isfinite(got).all()):
        raise RuntimeError("%s gradient disagrees with autograd through the "
                           "plain version: max abs err %g"
                           % (what, float(diff.max())))
    return float(diff.max())


def b5_check(x, scale, b, act, cot, what):
    """B5 against its plain version (``attn_check``) and its gradients
    under ``cot`` against autograd through the reference in x's dtype
    (in f32 the plain version itself; ``grad_check``) -> (max abs err,
    the gradients' max abs err)."""
    from mxnet_tpu_torch.kernels import mlp
    err = attn_check(mlp._launch(x, scale, b, act, mlp.DEFAULT_CONFIG),
                     mlp._plain_scale_bias_act(x, scale, b, act), what)
    ref = mlp._plain_scale_bias_act if x.dtype == torch.float32 \
        else mlp._reference
    _o, gk = grads_of(lambda a, s, c: mlp.fused_scale_bias_act(
        a, s, c, act=act), (x, scale, b), cot)
    _o, gp = grads_of(lambda a, s, c: ref(a, s, c, act), (x, scale, b), cot)
    return err, max(grad_check(a_, w_, what)
                    for a_, w_ in zip(gk, gp) if w_ is not None)


def b5_row(shape, dtype, dev, what, seed=23):
    """B5 at ``shape`` (+ bias -> ReLU, the fusion pass's ``fc_act``
    plan), held by ``b5_check`` as phase 7 holds it and timed beside its
    bound -> the row."""
    from mxnet_tpu_torch.kernels import mlp
    g = torch.Generator(device=dev).manual_seed(seed)
    dt = str(dtype)[6:]
    x = torch.randn(shape, generator=g, device=dev).to(dtype)
    b = torch.randn(shape[1], generator=g, device=dev)
    cot = torch.randn(shape, generator=g, device=dev)
    err, gerr = b5_check(x, None, b, "relu", cot, "scale_bias_act %s %s, "
                         "bias, ReLU (%s)" % (shape, dt, what))
    ms = time_ms(lambda: mlp._launch(x, None, b, "relu", mlp.DEFAULT_CONFIG),
                 dev)
    plain = time_ms(lambda: mlp._plain_scale_bias_act(x, None, b, "relu"),
                    dev)
    bytes_ms = (2 * x.numel() * x.element_size() + b.numel() * 4) \
        / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * x.numel() / F32_FLOPS * 1e3
    bound, by = bound_of(bytes_ms, ops_ms)
    log("  B5 at %s %s %s: agrees (max abs err %.3g, gradients %.3g); "
        "kernel_ms=%.5f plain_ms=%.5f bound_ms=%.5f (%s), share %.3f"
        % (what, shape, dt, err, gerr, ms, plain, bound, by, bound / ms))
    return {"shape": "%s %s, bias, ReLU" % (shape, dt), "ms": ms,
            "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None, "max_abs_err": err, "grad_max_abs_err": gerr}


def train_kernel_phase(dev):
    """B5 and B7 against their plain versions at the training path's
    shapes, forward and gradients, f32 and bf16; the new backwards of
    B3 and B2 against autograd through their plain versions; then the
    f32 times of B5 and B7 beside plain, library and bound."""
    from mxnet_tpu_torch.kernels import attention as attn
    from mxnet_tpu_torch.kernels import mlp, take
    from mxnet_tpu_torch.ops import pallas_flash as pf
    from mxnet_tpu_torch.parallel import blockwise_attention
    F = torch.nn.functional
    err, rows = {}, {}
    g = torch.Generator(device=dev).manual_seed(21)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def note(key, e):
        err[key] = max(err.get(key, 0.0), e)

    # -- B5 scale_bias_act: the MLP up-projection (8192, 3072) and ragged
    for shape in B5_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            nf = shape[1]
            x = rnd(*shape).to(dtype)
            sc = torch.rand(nf, generator=g, device=dev) * 2 - 0.5
            b = rnd(nf)
            cot = rnd(*shape)
            dt = str(dtype)[6:]
            for act in ("relu", "gelu", "identity"):
                for scale in (None, sc):
                    what = "scale_bias_act %s %s %s scale=%s" % (
                        shape, dt, act, scale is not None)
                    err_, gerr = b5_check(x, scale, b, act, cot, what)
                    note("scale_bias_act/" + dt, err_)
                    note("scale_bias_act_grad/" + dt, gerr)
    # -- B7 flash_fwd: the training shape, causal and not; causal
    # cross-length with fully masked rows; a ragged T
    for qshape, tk, causal in B7_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            dt = str(dtype)[6:]
            kshape = qshape[:2] + (tk, qshape[3])
            q, k, v = (rnd(*s).to(dtype) for s in (qshape, kshape, kshape))
            cot = rnd(*qshape)
            what = "flash_fwd q %s tk %d causal=%s %s" % (qshape, tk, causal,
                                                         dt)
            got = pf._launch(q, k, v, causal)
            # the kernel's KV tile: where the running max moves sets
            # the scale at which p rounds to bf16
            note("flash_fwd/" + dt, attn_check(
                got, blockwise_attention(q, k, v, pf.KV_TILE, causal),
                what))
            if causal and qshape[2] > tk:
                dead = got[:, :, :qshape[2] - tk]
                if not bool((dead == 0).all()):
                    raise RuntimeError("%s: fully masked rows are not 0 "
                                       "(max %g)" % (what, float(
                                           dead.abs().max())))
            _o, gk = grads_of(lambda a, b_, c: pf.flash_attention(
                a, b_, c, 128, 128, causal), (q, k, v), cot)
            _o, gp = grads_of(lambda a, b_, c: blockwise_attention(
                a, b_, c, 128, causal), (q, k, v), cot)
            for a_, w_ in zip(gk, gp):
                note("flash_fwd_grad/" + dt, grad_check(a_, w_, what))
            del q, k, v, gk, gp
    # -- B3 and B2 at the training path's shapes: forwards and the new
    # backwards
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        q, k, v = (rnd(*ATTN_SHAPE).to(dtype) for _ in range(3))
        cot = rnd(*ATTN_SHAPE)
        ok_, gk = grads_of(lambda a, b_, c: attn.flash_attention(
            a, b_, c, causal=True), (q, k, v), cot)
        op_, gp = grads_of(lambda a, b_, c: attn._plain_flash(
            a, b_, c, True), (q, k, v), cot)
        note("flash_attn@train/" + dt, attn_check(
            ok_, op_, "flash_attn %s causal %s" % (ATTN_SHAPE, dt)))
        for a_, w_ in zip(gk, gp):
            note("flash_attn_grad/" + dt, grad_check(
                a_, w_, "flash_attn backward %s" % dt))
        del q, k, v, gk, gp
        (V, C), ishape = EMBED
        table = rnd(V, C).to(dtype)
        ids = torch.randint(-300, V + 300, ishape, generator=g,
                            device=dev, dtype=torch.int32)
        # quarters in [-1, 1]: every partial sum of a row's cotangents is
        # exact even in bf16, so the two scatter-adds must be equal
        # whatever order their atomics add in
        cot = torch.randint(-4, 5, ishape + (C,), generator=g,
                            device=dev).float() / 4
        ok_, (dk, _) = grads_of(lambda w, i: take.take_rows(w, i),
                                (table, ids), cot)
        op_, (dp, _) = grads_of(lambda w, i: take._plain_take(w, i),
                                (table, ids), cot)
        if not torch.equal(ok_, op_):
            raise RuntimeError("take_rows (%s) at table %s is not bitwise "
                               "the clipped gather" % (dt, (V, C)))
        note("take_rows@train/" + dt, 0.0)
        if not torch.equal(dk, dp):
            raise RuntimeError("take_rows backward (%s) is not the plain "
                               "scatter-add: max abs err %g" % (dt, float(
                                   (dk.float() - dp.float()).abs().max())))
        note("take_rows_grad/" + dt, 0.0)
        del table, dk, dp
    log("training kernels vs plain (f32 and bf16, forward and gradients): "
        "max abs err %s" % json.dumps(err))
    # -- times (f32) at the training path's shapes
    x = rnd(*B5_SHAPES[0])
    b = rnd(B5_SHAPES[0][1])
    rows["scale_bias_act"] = {
        "shape": "%s f32, bias, ReLU" % (B5_SHAPES[0],),
        "ms": time_ms(lambda: mlp._launch(x, None, b, "relu",
                                          mlp.DEFAULT_CONFIG), dev),
        "plain_ms": time_ms(lambda: mlp._plain_scale_bias_act(
            x, None, b, "relu"), dev),
        "library_ms": None,
        "bytes_ms": (2 * x.numel() + b.numel()) * 4 / HBM_BYTES_PER_S * 1e3,
        "ops_ms": 2 * x.numel() / F32_FLOPS * 1e3}
    del x
    q, k, v = (rnd(*ATTN_SHAPE) for _ in range(3))
    B_, H_, T_, D_ = q.shape
    bytes_ms, ops_ms, core_ms = flash_bound_parts(
        q, B_ * H_ * T_ * (T_ + 1) // 2)

    def sdpa():
        return F.scaled_dot_product_attention(q, k, v, is_causal=True)
    rows["flash_fwd"] = {
        "shape": "%s f32 causal" % (ATTN_SHAPE,),
        "ms": time_ms(lambda: pf._launch(q, k, v, True), dev),
        "plain_ms": time_ms(lambda: blockwise_attention(q, k, v, 128, True),
                            dev),
        "library_ms": time_ms(sdpa, dev), "library_kernel": device_kernels(
            sdpa), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "core_ops_ms": core_ms}
    table = rnd(*EMBED[0])
    ids = torch.randint(-300, EMBED[0][0] + 300, EMBED[1], generator=g,
                        device=dev, dtype=torch.int32)
    flat = ids.reshape(-1).contiguous()
    clipped = ids.long().clamp(0, EMBED[0][0] - 1).reshape(-1)
    C_ = EMBED[0][1]
    rows["take_rows@train"] = {
        "shape": "table %s f32, ids %s" % (EMBED[0], EMBED[1]),
        "ms": time_ms(lambda: take._launch(table, flat,
                                           take.DEFAULT_CONFIG), dev),
        "plain_ms": time_ms(lambda: take._plain_take(table, ids), dev),
        "library_ms": time_ms(lambda: torch.index_select(table, 0, clipped),
                              dev),
        "bytes_ms": (2 * flat.numel() * C_ + flat.numel()) * 4
        / HBM_BYTES_PER_S * 1e3, "ops_ms": 0.0}
    del table
    rows["flash_attn@train"] = {
        "shape": "%s f32 causal" % (ATTN_SHAPE,),
        "ms": time_ms(lambda: attn._launch_flash(q, k, v, True), dev),
        "plain_ms": time_ms(lambda: attn._plain_flash(q, k, v, True), dev),
        **{key: rows["flash_fwd"][key] for key in (
            "library_ms", "library_kernel", "bytes_ms", "ops_ms",
            "core_ops_ms")}}
    for name, r in rows.items():
        r["bound_ms"], r["bound_by"] = bound_of(r["bytes_ms"], r["ops_ms"])
        log("  %-18s %-30s ms=%.5f plain_ms=%.5f library_ms=%s "
            "bound_ms=%.5f (%s)" % (name, r["shape"], r["ms"], r["plain_ms"],
                                    "%.5f" % r["library_ms"]
                                    if r["library_ms"] is not None
                                    else "none", r["bound_ms"],
                                    r["bound_by"]))
    for name in ("flash_fwd", "flash_attn@train"):
        log_flash_bound(name, rows[name])
    return err, rows


# ----------------------------------------------- training: the main path
def train_batches(n, batch, seq_len, vocab, lag, seed=0):
    rng = np.random.RandomState(seed)
    xs, ys = zip(*[mt.models.make_copy_batch(rng, batch, seq_len, vocab,
                                             lag) for _ in range(n)])
    return np.concatenate(xs), np.concatenate(ys)


def reset_train_counts():
    from mxnet_tpu_torch.kernels import attention as attn
    from mxnet_tpu_torch.kernels import mlp, take
    from mxnet_tpu_torch.ops import pallas_flash as pf
    tier.reset_stats()
    for m in (attn, mlp, take, pf):
        m.reset_launches()


def train_counts():
    from mxnet_tpu_torch.kernels import attention as attn
    from mxnet_tpu_torch.kernels import mlp, take
    from mxnet_tpu_torch.ops import pallas_flash as pf
    return {"flash_attn": attn.launches_by_kernel["flash_attn"],
            "scale_bias_act": mlp.launches, "take_rows": take.launches,
            "flash_fwd": pf.launches,
            "flash_attn_paged": attn.launches_by_kernel["flash_attn_paged"]}


ADAM = ("adam", {"learning_rate": 3e-4, "wd": 0.01})


def fit_steps(net, X, Y, dev, batch, arg_params=None, initializer=None,
              opt=ADAM):
    """``Module.fit`` for one epoch over (X, Y) with ``opt`` (Adam, lr
    3e-4, wd 0.01) and kvstore tpu_sync -> (module, losses, host times
    after each step). The loss is the mean cross-entropy of the step's
    outputs at its labels, read on the device after each step."""
    mod = mt.mod.Module(net, context=dev)
    losses, stamps = [], []

    def record(p):
        out = mod.get_outputs()[0]
        lab = p.locals["data_batch"].label[0].to(out.device).long()
        pick = out.gather(-1, lab.unsqueeze(-1)).clamp_min(1e-30)
        losses.append(float(-pick.log().mean()))   # syncs the card
        stamps.append(time.perf_counter())
    stamps.append(time.perf_counter())
    mod.fit(mt.io.NDArrayIter(X, Y, batch_size=batch), num_epoch=1,
            kvstore="tpu_sync", optimizer=opt[0], optimizer_params=opt[1],
            initializer=initializer, arg_params=arg_params,
            eval_metric=None, batch_end_callback=record)
    return mod, losses, stamps


def step_grads(net, params, X, Y, dev, tier_val, B_=GPT_TRAIN["batch"]):
    """Gradients of the first batch (``B_`` rows) at ``params`` through a
    bound executor at ``tier_val``."""
    T_ = X.shape[1]
    with mt.config.override(kernel_tier=tier_val):
        ex = net.simple_bind(dev, data=(B_, T_), softmax_label=(B_, T_))
    ex.copy_params_from(params)
    ex.forward(is_train=True, data=X[:B_], softmax_label=Y[:B_])
    ex.backward()
    return {k: v for k, v in ex.grad_dict.items()}


def rel_grad_err(got, want):
    """Per parameter: max |got - want| over the largest |want|."""
    return {k: float((got[k].to(want[k].device) - want[k]).abs().max()
                     / want[k].abs().max().clamp_min(1e-30))
            for k in want if k not in ("data", "softmax_label")}


# A ReLU input within f32 noise of 0 may open on the card and not on
# the CPU (their GEMMs sum in other orders). The cut-depth checks allow
# at most RELU_FLIPS_MAX such flips in all, each within RELU_FLIP_NOISE
# of its tensor's largest magnitude on both sides; more flips, or one
# far from 0, is a fault in the forward.
RELU_FLIPS_MAX = 4
RELU_FLIP_NOISE = 1e-4


def relu_flips(pairs):
    """``{name: (a, b)}`` ReLU inputs of two runs -> ``({name: sign
    flips}, the largest |input| at a flip, on either side, over its
    tensor's largest magnitude)``."""
    flips, worst = {}, 0.0
    for name, (a, b) in pairs.items():
        flip = (a > 0) != (b > 0)
        flips[name] = int(flip.sum())
        if flips[name]:
            far = torch.maximum(a.abs(), b.abs())[flip].max()
            worst = max(worst, float(far / a.abs().max().clamp_min(1e-30)))
    return flips, worst


def check_relu_flips(flips, worst, what):
    n = sum(flips.values())
    if n > RELU_FLIPS_MAX or worst > RELU_FLIP_NOISE:
        raise RuntimeError(
            "%s: %d ReLU inputs flipped sign between card and CPU (at most "
            "%d allowed), the farthest %.3g of its tensor's largest "
            "magnitude from 0 (at most %g): %s"
            % (what, n, RELU_FLIPS_MAX, worst, RELU_FLIP_NOISE,
               json.dumps(flips)))


def card_relu_grads(net, params, X, Y, dev, B_):
    """Gradients of ``X[:B_]`` at ``params`` on ``dev`` at tier auto,
    beside each block's MLP ReLU as that forward took it: its input
    (the up-projection with its bias) and its decision (the fused
    ``fc_act`` output above 0), both on the CPU."""
    from mxnet_tpu_torch.kernels import mlp
    fn, taps = mlp.fused_scale_bias_act, []

    def tap(y, scale=None, bias=None, **kw):
        out = fn(y, scale, bias, **kw)
        if kw.get("act") == "relu":
            taps.append(((y + bias).detach().float().cpu(),
                         (out > 0).detach().float().cpu()))
        return out
    mlp.fused_scale_bias_act = tap
    try:
        grads = step_grads(net, params, X, Y, dev, "auto", B_=B_)
    finally:
        mlp.fused_scale_bias_act = fn
    return grads, taps


def masked_cpu_grads(net, params, X, Y, masks, B_):
    """Gradients of ``X[:B_]`` at ``params`` on the CPU at tier off with
    each MLP ReLU replaced by ``x * mask`` (``masks`` in block order):
    the same forward up to the sign decisions, with the decisions given.
    Returns them beside the ReLU inputs the CPU saw."""
    T_ = X.shape[1]
    with mt.config.override(kernel_tier="off"):
        ex = net.simple_bind("cpu", data=(B_, T_), softmax_label=(B_, T_))
        ex.copy_params_from(params)
        with ReluTape() as tape:     # bound first: shape inference runs ops
            tape.masks = list(masks)
            ex.forward(is_train=True, data=X[:B_], softmax_label=Y[:B_])
            ex.backward()
    grads = dict(ex.grad_dict)
    if len(tape.seen) != len(masks) or tape.masks:
        raise RuntimeError("cut depth: the CPU's forward took %d ReLUs, "
                           "%d decisions given"
                           % (len(tape.seen), len(masks)))
    return grads, tape.seen


def cut_depth_check(dev, report):
    """The GPT cut to 2 layers at T 128, batch 2, on the card against
    the CPU (plain versions). First each step's gradients, at Xavier's
    weights on batch 1 and at the CPU's weights after step 1 on batch 2.
    The card's GEMMs sum in another order than the CPU's, so a ReLU
    input within f32 noise of 0 may open on one side only; that moves
    the unit's row of the up-projection's gradient by a whole token's
    share, and every gradient upstream of it. So the card's gradients
    are held against the CPU's taking the card's ReLU decisions
    (``masked_cpu_grads`` with the masks of the card's own fused
    ``fc_act`` outputs), within 1e-3 of each tensor's largest magnitude,
    the limit the tiers are held to; the plain CPU's difference and
    the row where it is largest are printed beside. The sign flips are
    held to ``check_relu_flips`` (at most 4, each within f32 noise of
    0). Then 2 SGD-momentum steps by ``Module.fit`` on each: losses
    within 1e-5 relative and every parameter within 1e-4. The lr is
    1e-4 (largest update about 0.014). At lr 0.01 the first step moves
    elements by up to about 3, and summation-order noise is then
    amplified to 1e-3 in the parameters after step 2: the line printed
    after the check sets the card and the CPU there beside two CPU runs
    which differ only in their thread count."""
    P = GPT_TRAIN
    small = mt.models.gpt_lm(P["vocab"], P["dim"], P["heads"], 2, 128)
    Xs, Ys = train_batches(2, 2, 128, P["vocab"], P["lag"], seed=1)
    init = mt.mod.Module(small, context="cpu")
    init.bind([("data", (2, 128))], [("softmax_label", (2, 128))])
    init.init_params(mt.init.Xavier(seed=0))
    p0 = init.get_params()[0]
    del init

    def sgd(lr):
        return ("sgd", {"learning_rate": lr, "momentum": 0.9, "wd": 0.01})

    def fit_params(d, X, Y, lr):
        m, losses, _s = fit_steps(small, X, Y, d, 2, arg_params=p0,
                                  opt=sgd(lr))
        return {k: v.cpu() for k, v in m.get_params()[0].items()}, losses

    # -- each step's gradients: the card's against the CPU's through the
    # card's ReLU decisions, the plain CPU's beside, and the sign flips
    # of the ReLU inputs between the card and the CPU
    mlps = [n.name for n in small._topo()
            if not n.is_variable and n.name.endswith("mlp1")]
    p1, _l = fit_params("cpu", Xs[:2], Ys[:2], 1e-4)
    grad_err, plain_err, pairs, where = {}, {}, {}, {}
    for step, (params, X, Y) in enumerate(((p0, Xs[:2], Ys[:2]),
                                           (p1, Xs[2:], Ys[2:])), 1):
        got, taps = card_relu_grads(small, params, X, Y, dev, 2)
        if len(taps) != len(mlps):
            raise RuntimeError("cut depth: the card's forward fused %d MLP "
                               "ReLUs, expected %d" % (len(taps), len(mlps)))
        want, seen = masked_cpu_grads(small, params, X, Y,
                                      [m for _a, m in taps], 2)
        plain = step_grads(small, params, X, Y, "cpu", "auto", B_=2)
        for k, e in rel_grad_err(got, want).items():
            grad_err["step%d/%s" % (step, k)] = e
        for k, e in rel_grad_err(got, plain).items():
            plain_err["step%d/%s" % (step, k)] = e
        for name, a, (b, _m) in zip(mlps, seen, taps):
            pairs["step%d/%s" % (step, name)] = (a, b)
            flip = ((a > 0) != (b > 0)).reshape(-1, a.shape[-1])
            # the up-projection's plain gradient row that differs most,
            # and whether that unit's ReLU input flipped at any token
            w = name + "_weight"
            row = int((got[w].cpu() - plain[w]).abs().amax(1).argmax())
            where["step%d/%s" % (step, w)] = {
                "row": row, "row_flipped": bool(flip[:, row].any())}
    flips, flip_far = relu_flips(pairs)
    del pairs
    worst_g = max(grad_err, key=grad_err.get)
    worst_pl = max(plain_err, key=plain_err.get)
    # -- 2 steps by Module.fit on each
    cut, cut_loss = {}, {}
    for d in (dev, "cpu"):
        cut[str(d)], cut_loss[str(d)] = fit_params(d, Xs, Ys, 1e-4)
    cut_err = {k: float((cut[str(dev)][k] - v).abs().max())
               for k, v in cut["cpu"].items()}
    max_update = max(float((v - p0[k]).abs().max())
                     for k, v in cut["cpu"].items())
    loss_err = max(abs(a - b) / abs(b) for a, b in
                   zip(cut_loss[str(dev)], cut_loss["cpu"]))
    worst = max(cut_err, key=cut_err.get)
    log("cut depth (2 layers, T 128, batch 2), card vs CPU: each step's "
        "gradients within %.3g of the tensor's largest magnitude (worst "
        "%s) of the CPU's taking the card's ReLU decisions; ReLU inputs "
        "of opposite sign %s, the farthest %.3g of its tensor's largest "
        "magnitude from 0; the plain CPU's within %.3g (worst %s), the "
        "up-projections' most different gradient rows %s; 2 SGD-momentum "
        "steps at lr 1e-4: losses within %.3g relative, parameters within "
        "%.3g (worst %s; largest update %.3g)"
        % (grad_err[worst_g], worst_g, json.dumps(flips), flip_far,
           plain_err[worst_pl], worst_pl, json.dumps(where), loss_err,
           cut_err[worst], worst, max_update))
    report["train"].update(cut_depth_grad_err=grad_err,
                           cut_depth_plain_grad_err=plain_err,
                           cut_depth_relu_flips=flips,
                           cut_depth_relu_flip_far=flip_far,
                           cut_depth_worst_rows=where,
                           cut_depth_param_err=cut_err,
                           cut_depth_max_update=max_update,
                           cut_depth_loss_err=loss_err)
    if grad_err[worst_g] > 1e-3 or cut_err[worst] > 1e-4 or loss_err > 1e-5:
        raise RuntimeError("card and CPU disagree: gradients %g (%s), "
                           "losses %g relative, parameters %g (%s)"
                           % (grad_err[worst_g], worst_g, loss_err,
                              cut_err[worst], worst))
    check_relu_flips(flips, flip_far, "cut depth")
    # -- lr 0.01: the card against the CPU, and the CPU against itself
    # at one thread
    big = {"card": fit_params(dev, Xs, Ys, 1e-2)[0],
           "cpu": fit_params("cpu", Xs, Ys, 1e-2)[0]}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        big["cpu1"] = fit_params("cpu", Xs, Ys, 1e-2)[0]
    finally:
        torch.set_num_threads(threads)

    def apart(a, b):
        return max(float((big[a][k] - big[b][k]).abs().max()) for k in p0)
    spread = {"card_vs_cpu": apart("card", "cpu"),
              "cpu_vs_cpu1": apart("cpu", "cpu1"),
              "largest_update": max(float((big["cpu"][k] - p0[k]).abs().max())
                                    for k in p0)}
    log("the same 2 steps at lr 0.01 (largest update %.3g): card vs CPU "
        "%.3g apart, CPU at %d threads vs CPU at 1 thread %.3g apart"
        % (spread["largest_update"], spread["card_vs_cpu"], threads,
           spread["cpu_vs_cpu1"]))
    report["train"]["cut_depth_lr_0.01"] = spread


def step_profile(mod, X, Y):
    """One fused step: forward, backward and update timed with CUDA
    events (median of 3 steps), then torch.profiler over one more step:
    device busy share, the top kernels, and the device time inside the
    named backward recomputes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fused, ex = mod._fused, mod._exec
    B_ = GPT_TRAIN["batch"]
    ex.set_inputs(data=X[:B_], softmax_label=Y[:B_])
    parts = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        outs, _auxu, leaves = fused.forward()
        ev[1].record()
        grads = fused.backward(outs, leaves)
        ev[2].record()
        fused.apply(grads, mod._fused_opt_state)
        ev[3].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        parts.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                      ev[2].elapsed_time(ev[3]), wall))
        del outs, leaves, grads
    med = [float(np.median([p[i] for p in parts])) for i in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused.step(mod._fused_opt_state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    # the named backward ranges also appear as device events spanning
    # their kernels; they are read apart and kept out of the busy sum
    names = ("flash_attn.backward", "scale_bias_act.backward")
    ranges = {e.key: e.device_time_total for e in avgs if e.key in names}
    kernels = [(e.key, e.self_device_time_total, e.count) for e in avgs
               if e.device_type == DeviceType.CUDA and e.key not in names]
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {"forward_ms": med[0], "backward_ms": med[1], "update_ms": med[2],
            "wall_ms": med[3], "profiled_wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3, "device_busy_share": busy / wall_us,
            "flash_attn_backward_ms": ranges.get("flash_attn.backward",
                                                 0.0) / 1e3,
            "scale_bias_act_backward_ms": ranges.get(
                "scale_bias_act.backward", 0.0) / 1e3,
            "top_kernels": [{"name": k[0][:100], "ms": k[1] / 1e3,
                             "calls": k[2]} for k in top]}


def reference_backward_ms(dev):
    """CUDA-event time of B3's backward alone (the vjp of the reference
    attention, recomputed) at the training shape, median of 5."""
    from mxnet_tpu_torch.kernels import attention as attn
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v, cot = (torch.randn(ATTN_SHAPE, generator=g, device=dev)
                    for _ in range(4))

    def bwd():
        a, b, c = (t.detach().requires_grad_(True) for t in (q, k, v))
        o = attn.reference_attention(a, b, c, causal=True)
        torch.autograd.grad(o, (a, b, c), cot)
    return time_ms(bwd, dev, iters=5, warmup=1)


def train_main_path(dev, card, report):
    """Phase 8: the GPT at GPT-2 small's widths trained through
    Module.fit at tier auto and tier off, held against each other, a
    repeated batch and a cut-depth CPU run; then the step's numbers."""
    P = GPT_TRAIN
    net = mt.models.gpt_lm(P["vocab"], P["dim"], P["heads"], P["layers"],
                           P["seq_len"])
    steps = 8
    X, Y = train_batches(steps, P["batch"], P["seq_len"], P["vocab"],
                         P["lag"])
    tokens = P["batch"] * P["seq_len"]
    # -- tier auto: the main path, counts zeroed just before
    t0 = time.perf_counter()
    init = mt.mod.Module(net, context=dev)
    init.bind([("data", (P["batch"], P["seq_len"]))],
              [("softmax_label", (P["batch"], P["seq_len"]))])
    init.init_params(mt.init.Xavier(seed=0))
    params0 = init.get_params()[0]
    nparam = sum(v.numel() for v in params0.values())
    del init
    log("GPT at GPT-2-small widths (%s): %.1f M f32 parameters, Xavier "
        "(seed 0) in %.1fs" % (json.dumps(P), nparam / 1e6,
                               time.perf_counter() - t0))
    reset_train_counts()
    mod, loss_auto, stamps = fit_steps(net, X, Y, dev, P["batch"],
                                       arg_params=params0)
    torch.cuda.synchronize()
    auto_counts = train_counts()
    auto_stats = tier.stats()
    L = P["layers"]
    want = {"flash_attn": L * steps, "scale_bias_act": L * steps,
            "take_rows": steps, "flash_fwd": 0, "flash_attn_paged": 0}
    log("train path, tier auto: %d steps, losses %s, launches %s, tier %s"
        % (steps, ["%.5f" % x for x in loss_auto], auto_counts,
           json.dumps(auto_stats["dispatch"])))
    if auto_counts != want or auto_stats["fallback"]:
        raise RuntimeError("tier auto: launches %s (expected %s), fallback "
                           "%s" % (auto_counts, want,
                                   auto_stats["fallback"]))
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    torch.cuda.reset_peak_memory_stats(dev)
    prof = step_profile(mod, X, Y)
    prof["peak_memory_bytes"] = torch.cuda.max_memory_allocated(dev)
    del mod
    torch.cuda.empty_cache()
    # -- tier off from the same weights
    reset_train_counts()
    with mt.config.override(kernel_tier="off"):
        mod_off, loss_off, _ = fit_steps(net, X, Y, dev, P["batch"],
                                         arg_params=params0)
    torch.cuda.synchronize()
    off_counts = train_counts()
    off_stats = tier.stats()
    want_off = {"flash_attn": 0, "scale_bias_act": 0, "take_rows": 0,
                "flash_fwd": L * steps, "flash_attn_paged": 0}
    log("train path, tier off: losses %s, launches %s"
        % (["%.5f" % x for x in loss_off], off_counts))
    if off_counts != want_off or off_stats["dispatch"]:
        raise RuntimeError("tier off: launches %s (expected %s), dispatch "
                           "%s" % (off_counts, want_off,
                                   off_stats["dispatch"]))
    del mod_off
    torch.cuda.empty_cache()
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_auto, loss_off))
    if not all(np.isfinite(loss_auto + loss_off)) or loss_rel > 1e-4:
        raise RuntimeError("losses disagree across tiers (worst relative "
                           "%g) or are not finite" % loss_rel)
    # -- step 1's gradients at both tiers
    g_auto = step_grads(net, params0, X, Y, dev, "auto")
    g_off = step_grads(net, params0, X, Y, dev, "off")
    grad_rel = rel_grad_err(g_auto, g_off)
    worst = max(grad_rel, key=grad_rel.get)
    log("tiers agree: losses within %.3g relative; step-1 gradients within "
        "%.3g of each tensor's largest magnitude (worst %s)"
        % (loss_rel, grad_rel[worst], worst))
    if grad_rel[worst] > 1e-3:
        raise RuntimeError("step-1 gradients disagree across tiers: %s %g"
                           % (worst, grad_rel[worst]))
    del g_auto, g_off
    torch.cuda.empty_cache()
    # -- one batch repeated 6 times: the loss falls
    Xr = np.tile(X[:P["batch"]], (6, 1))
    Yr = np.tile(Y[:P["batch"]], (6, 1))
    mod_r, loss_rep, _ = fit_steps(net, Xr, Yr, dev, P["batch"],
                                   arg_params=params0)
    del mod_r
    torch.cuda.empty_cache()
    log("one batch six times: losses %s" % ["%.5f" % x for x in loss_rep])
    if not loss_rep[-1] < loss_rep[0]:
        raise RuntimeError("the loss did not fall on a repeated batch")
    # -- the numbers
    n_dense = nparam - P["vocab"] * P["dim"] - P["seq_len"] * P["dim"]
    T_ = P["seq_len"]
    attn_flops = 3 * 4 * P["batch"] * P["heads"] * (T_ * (T_ + 1) // 2) \
        * (P["dim"] // P["heads"]) * L
    flops = 6 * n_dense * tokens + attn_flops
    p50 = float(np.median(step_ms))
    ref_bwd = reference_backward_ms(dev)
    perf = {"step_ms": step_ms, "step_ms_p50": p50,
            "tokens_per_s": tokens / (p50 / 1e3),
            "model_flops_per_step": flops,
            "model_flops_share_of_f32_peak": flops / (p50 / 1e3) / F32_FLOPS,
            "reference_backward_ms_x12": 12 * ref_bwd, "profile": prof}
    log("train step at GPT-2-small widths, batch 8 x 1024, f32: p50 %.2f ms "
        "over steps 2-%d, %.0f tokens/s, %.2f TFLOP model FLOPs per step = "
        "%.1f%% of the 67 TFLOP/s f32 peak  [%s]"
        % (p50, steps, tokens / (p50 / 1e3), flops / 1e12,
           100 * perf["model_flops_share_of_f32_peak"], card))
    log("one step: forward %.2f ms, backward %.2f ms, update %.2f ms (CUDA "
        "events), wall %.2f ms; profiled: %.2f ms wall, %.2f ms device (busy "
        "%.1f%%), flash_attn.backward %.2f ms (%.1f%% of the device time), "
        "scale_bias_act.backward %.2f ms; B3's reference backward alone x12: "
        "%.2f ms; peak memory %.2f GB  [%s]"
        % (prof["forward_ms"], prof["backward_ms"], prof["update_ms"],
           prof["wall_ms"], prof["profiled_wall_ms"], prof["device_ms"],
           100 * prof["device_busy_share"], prof["flash_attn_backward_ms"],
           100 * prof["flash_attn_backward_ms"] / prof["device_ms"],
           prof["scale_bias_act_backward_ms"], 12 * ref_bwd,
           prof["peak_memory_bytes"] / 1e9, card))
    log("top kernels of one step: " + "; ".join(
        "%s %.2f ms x%d" % (k["name"][:60], k["ms"], k["calls"])
        for k in prof["top_kernels"][:8]))
    report.update(train={"launches_auto": auto_counts,
                         "launches_off": off_counts,
                         "tier_stats_auto": auto_stats,
                         "losses_auto": loss_auto, "losses_off": loss_off,
                         "loss_rel": loss_rel, "grad_rel": grad_rel,
                         "losses_repeated": loss_rep, "perf": perf})
    cut_depth_check(dev, report)
    return {"scale_bias_act": auto_counts["scale_bias_act"],
            "flash_attn": auto_counts["flash_attn"],
            "take_rows": auto_counts["take_rows"],
            "flash_fwd": off_counts["flash_fwd"]}


# ------------------------------------------------- Gluon: the main path
GLUON_STEPS = 8          # hybridized, at each tier
GLUON_EAGER_STEPS = 5    # un-hybridized, tier auto
WANT_AUTO = {"flash_attn": GPT_TRAIN["layers"], "take_rows": 1,
             "scale_bias_act": 0, "flash_fwd": 0, "flash_attn_paged": 0}
WANT_OFF = {"flash_attn": 0, "take_rows": 0, "scale_bias_act": 0,
            "flash_fwd": GPT_TRAIN["layers"], "flash_attn_paged": 0}


def gluon_gpt(layers, seq_len):
    """The GPT of examples/train_transformer_lm.py, class for class
    (``tests/gluon_gpt.py``), on the port's Gluon at GPT_TRAIN's widths
    and the given depth and context."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from gluon_gpt import gpt_classes
    _attn, _block, GPT = gpt_classes(mt, mt.gluon, mt.gluon.nn)
    P = GPT_TRAIN
    return GPT(P["vocab"], P["dim"], P["heads"], layers, seq_len)


def gluon_params(net):
    """{name relative to the root prefix: Parameter}."""
    return {n[len(net.prefix):]: p for n, p in net.collect_params().items()}


def gluon_init(net, ctx, X):
    """Xavier (seed 0; pos_weight Normal(0.02)) on ``ctx``; one forward
    outside recording completes the deferred shapes. Returns a copy of
    every parameter, by relative name."""
    net.initialize(mt.init.Xavier(seed=0), ctx=ctx)
    with mt.autograd.predict_mode():
        net(mt.nd.array(X[:1], ctx=ctx))
    return {k: p.data()._data.detach().clone()
            for k, p in gluon_params(net).items()}


def gluon_load(net, snap):
    """Every parameter set (in place) from ``snap``."""
    for k, p in gluon_params(net).items():
        p.set_data(mt.nd.NDArray(snap[k].to(p.data()._data.device)))


def gluon_train(net, X, Y, ctx, steps, batch, hybrid, opt=ADAM,
                grads_at=None):
    """The example's loop: ``autograd.record()`` -> ``loss.backward()`` ->
    ``trainer.step(1)``, on batches of ``batch`` rows of (X, Y). Returns
    the losses (read after each step, as the example does), the host
    time of each step, the launches each step made, and a copy of the
    gradients of step ``grads_at`` (0-based) before its update."""
    lag = GPT_TRAIN["lag"]
    net.hybridize(active=hybrid, static_alloc=True)
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mt.gluon.Trainer(net.collect_params(), opt[0], dict(opt[1]))
    cuda = ctx.device_type == "gpu"
    losses, walls, census, grads = [], [], [], None
    for s in range(steps):
        before = train_counts()
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = mt.nd.array(X[s * batch:(s + 1) * batch], ctx=ctx)
        y = mt.nd.array(Y[s * batch:(s + 1) * batch], ctx=ctx)
        with mt.autograd.record():
            logits = net(x)
            loss = loss_fn(logits[:, lag:, :], y[:, lag:]).mean()
        loss.backward()
        if s == grads_at:
            grads = {k: p.grad()._data.detach().clone()
                     for k, p in gluon_params(net).items()}
        trainer.step(1)
        losses.append(float(loss.asnumpy()))
        walls.append((time.perf_counter() - t0) * 1e3)
        after = train_counts()
        census.append({k: after[k] - before[k] for k in after})
        del logits, loss
    return losses, walls, census, grads


def gluon_step_profile(net, X, Y, ctx):
    """One hybridized step at tier auto: forward (with the loss),
    backward and update timed with CUDA events (median of 3), then
    torch.profiler over one more step: busy share, B3's recomputed
    backward (its named range) and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    B_, lag = GPT_TRAIN["batch"], GPT_TRAIN["lag"]
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mt.gluon.Trainer(net.collect_params(), ADAM[0], dict(ADAM[1]))
    x = mt.nd.array(X[:B_], ctx=ctx)
    y = mt.nd.array(Y[:B_], ctx=ctx)

    def step(ev=None):
        if ev:
            ev[0].record()
        with mt.autograd.record():
            loss = loss_fn(net(x)[:, lag:, :], y[:, lag:]).mean()
        if ev:
            ev[1].record()
        loss.backward()
        if ev:
            ev[2].record()
        trainer.step(1)
        if ev:
            ev[3].record()
    split = step_split(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    names = ("flash_attn.backward",)
    ranges = {e.key: e.device_time_total for e in avgs if e.key in names}
    kernels = [(e.key, e.self_device_time_total, e.count) for e in avgs
               if e.device_type == DeviceType.CUDA and e.key not in names]
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {**split, "profiled_wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3, "device_busy_share": busy / wall_us,
            "flash_attn_backward_ms": ranges.get("flash_attn.backward",
                                                 0.0) / 1e3,
            "kernel_launches": sum(k[2] for k in kernels),
            "top_kernels": [{"name": k[0][:100], "ms": k[1] / 1e3,
                             "calls": k[2]} for k in top]}


def check_census(census, want, what):
    bad = [(i + 1, c) for i, c in enumerate(census) if c != want]
    if bad:
        raise RuntimeError("%s: launches per step %s, expected %s at every "
                           "step" % (what, bad[:3], want))


def gluon_relu_inputs(net, ctx, X):
    """Each block's MLP up-projection before its ReLU (the input of the
    ``mlp1`` Dense's Activation child) on ``X``, on the CPU, beside the
    relative name of that Dense's weight."""
    seen = []
    blocks = list(net.blocks)
    for blk in blocks:
        blk.mlp1.act.register_forward_pre_hook(
            lambda _b, args: seen.append(args[0].detach().float().cpu()))
    try:
        with mt.autograd.predict_mode():
            net(mt.nd.array(X, ctx=ctx))
    finally:
        for blk in blocks:
            blk.mlp1.act._forward_pre_hooks.clear()
    return [(blk.mlp1.weight.name[len(net.prefix):], a)
            for blk, a in zip(blocks, seen)]


def gluon_grads(net, X, Y, ctx, masks=None):
    """The gradients of the example's loss on (X, Y) at the current
    weights, on the CPU. ``masks`` (one per block) replace each MLP's
    ReLU by ``x * mask``: the same forward up to the sign decisions, with
    the decisions given."""
    lag = GPT_TRAIN["lag"]
    acts = [blk.mlp1.act for blk in net.blocks] if masks else []
    for act, m in zip(acts, masks or ()):
        act.hybrid_forward = (lambda F, x, _m=m: x * _m.to(x.device))
    try:
        x, y = mt.nd.array(X, ctx=ctx), mt.nd.array(Y, ctx=ctx)
        with mt.autograd.record():
            loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(x)[:, lag:, :], y[:, lag:]).mean()
        loss.backward()
    finally:
        for act in acts:
            del act.hybrid_forward
    return {k: p.grad()._data.detach().cpu().clone()
            for k, p in gluon_params(net).items()}


def gluon_cut_depth(dev, report):
    """The Gluon GPT cut to 2 layers at T 128, batch 2, on the card
    against the CPU, from the CPU's Xavier draw. The card's GEMMs sum in
    another order than the CPU's, so a ReLU input within f32 noise of 0
    may open on one side only; one such token moves every gradient
    upstream of it (the model is well conditioned otherwise: on the CPU
    a change of thread count moves them by 1e-6). So step 1's gradients
    on the card are held against the CPU's taking the card's ReLU
    decisions (``gluon_grads`` with the card's masks), within 1e-3 of
    each tensor's largest magnitude, the limit of ``cut_depth_check``;
    the plain CPU's difference is printed beside. The flips themselves
    are held to ``check_relu_flips``: at most 4, each within f32 noise of
    0. Then after 2 SGD-momentum steps (lr 1e-4) losses within 1e-5
    relative and every parameter within 1e-4."""
    P = GPT_TRAIN
    Xs, Ys = train_batches(2, 2, 128, P["vocab"], P["lag"], seed=1)
    sgd = ("sgd", {"learning_rate": 1e-4, "momentum": 0.9, "wd": 0.01})
    runs, nets = {}, {}
    p0 = None
    for name, ctx in (("cpu", mt.cpu()), ("card", mt.gpu(0))):
        net = nets[name] = gluon_gpt(2, 128)
        snap = gluon_init(net, ctx, Xs)
        if p0 is None:
            p0 = {k: v.cpu() for k, v in snap.items()}
        gluon_load(net, p0)
        net.hybridize(active=True)
        pre = gluon_relu_inputs(net, ctx, Xs[:2])
        losses, _w, _c, grads = gluon_train(net, Xs, Ys, ctx, 2, 2, True,
                                            opt=sgd, grads_at=0)
        runs[name] = (losses, {k: v.cpu() for k, v in grads.items()},
                      {k: p.data()._data.detach().cpu().clone()
                       for k, p in gluon_params(net).items()}, pre)
    del nets["card"]
    (lc, gc_, pc, prc), (lg, gg, pg, prg) = runs["cpu"], runs["card"]
    flips, flip_far = relu_flips({name: (a, b) for (name, a), (_n, b)
                                  in zip(prc, prg)})
    gluon_load(nets["cpu"], p0)
    gm = gluon_grads(nets["cpu"], Xs[:2], Ys[:2], mt.cpu(),
                     masks=[(b > 0).float() for _n, b in prg])

    def rel(want):
        return {k: float((gg[k] - v).abs().max()
                         / v.abs().max().clamp_min(1e-30))
                for k, v in want.items()}
    grad_err, plain_err = rel(gm), rel(gc_)
    param_err = {k: float((pg[k] - v).abs().max()) for k, v in pc.items()}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    wg = max(grad_err, key=grad_err.get)
    wpl = max(plain_err, key=plain_err.get)
    wp = max(param_err, key=param_err.get)
    log("gluon cut depth (2 layers, T 128, batch 2), card vs CPU: step-1 "
        "gradients within %.3g of the tensor's largest magnitude (worst %s) "
        "of the CPU's taking the card's ReLU decisions; ReLU inputs of "
        "opposite sign %s, the farthest %.3g of its tensor's largest "
        "magnitude from 0; the plain CPU's within %.3g (worst %s); after 2 "
        "SGD-momentum steps at lr 1e-4 losses within %.3g relative, "
        "parameters within %.3g (worst %s)"
        % (grad_err[wg], wg, json.dumps(flips), flip_far, plain_err[wpl],
           wpl, loss_err, param_err[wp], wp))
    report["gluon"].update(cut_depth_grad_err=grad_err,
                           cut_depth_plain_grad_err=plain_err,
                           cut_depth_relu_flips=flips,
                           cut_depth_relu_flip_far=flip_far,
                           cut_depth_param_err=param_err,
                           cut_depth_loss_err=loss_err)
    if grad_err[wg] > 1e-3 or param_err[wp] > 1e-4 or loss_err > 1e-5:
        raise RuntimeError("gluon: card and CPU disagree at cut depth: "
                           "gradients %g (%s), losses %g, parameters %g (%s)"
                           % (grad_err[wg], wg, loss_err, param_err[wp],
                              wp))
    check_relu_flips(flips, flip_far, "gluon cut depth")


def gluon_main_path(dev, card, report):
    """Phase 9: the example's GPT through Gluon (hybridized, Adam) at
    GPT-2 small's widths, at tier auto and tier off from the same
    weights, and un-hybridized at auto; the launch census of every step,
    the tiers and the two modes held against each other on step 1, the
    card against the CPU at cut depth, a falling loss on a repeated
    batch; then the step's numbers beside Module.fit's from phase 8."""
    P = GPT_TRAIN
    L, B_ = P["layers"], P["batch"]
    ctx = mt.gpu(0)
    X, Y = train_batches(GLUON_STEPS, B_, P["seq_len"], P["vocab"],
                         P["lag"])
    tokens = B_ * P["seq_len"]
    t0 = time.perf_counter()
    net = gluon_gpt(L, P["seq_len"])
    p0 = gluon_init(net, ctx, X)
    nparam = sum(v.numel() for v in p0.values())
    head_key = net.head.weight.name[len(net.prefix):]
    log("Gluon GPT (tests/gluon_gpt.py) at GPT-2-small widths: %.1f M f32 "
        "parameters in %d tensors, Xavier (seed 0) in %.1fs"
        % (nparam / 1e6, len(p0), time.perf_counter() - t0))
    report["gluon"] = {}
    # -- the main path: hybridized, tier auto; counts zeroed just before
    reset_train_counts()
    loss_auto, wall_auto, census_auto, g_auto = gluon_train(
        net, X, Y, ctx, GLUON_STEPS, B_, True, grads_at=0)
    torch.cuda.synchronize()
    auto_counts = train_counts()
    auto_stats = tier.stats()
    log("gluon path, hybridized, tier auto: losses %s, launches %s, tier %s"
        % (["%.5f" % v for v in loss_auto], auto_counts,
           json.dumps(auto_stats["dispatch"])))
    check_census(census_auto, WANT_AUTO, "gluon tier auto")
    if auto_stats["fallback"]:
        raise RuntimeError("gluon tier auto: fallback %s"
                           % auto_stats["fallback"])
    # -- hybridized, tier off, from the same weights
    gluon_load(net, p0)
    reset_train_counts()
    with mt.config.override(kernel_tier="off"):
        loss_off, wall_off, census_off, g_off = gluon_train(
            net, X, Y, ctx, GLUON_STEPS, B_, True, grads_at=0)
    torch.cuda.synchronize()
    off_counts = train_counts()
    log("gluon path, hybridized, tier off: losses %s, launches %s"
        % (["%.5f" % v for v in loss_off], off_counts))
    check_census(census_off, WANT_OFF, "gluon tier off")
    # -- un-hybridized (eager), tier auto, from the same weights
    gluon_load(net, p0)
    reset_train_counts()
    loss_eager, wall_eager, census_eager, g_eager = gluon_train(
        net, X, Y, ctx, GLUON_EAGER_STEPS, B_, False, grads_at=0)
    torch.cuda.synchronize()
    log("gluon path, eager, tier auto: losses %s, launches %s"
        % (["%.5f" % v for v in loss_eager], train_counts()))
    check_census(census_eager, WANT_AUTO, "gluon eager")
    # -- step 1 held: auto against off, hybridized against eager
    checks = {}
    for what, want_l, want_g in (("tier off", loss_off, g_off),
                                 ("eager", loss_eager, g_eager)):
        lrel = max(abs(a - b) / abs(b) for a, b in zip(loss_auto, want_l))
        grel = {k: float((g_auto[k] - v).abs().max()
                         / v.abs().max().clamp_min(1e-30))
                for k, v in want_g.items()}
        worst = max(grel, key=grel.get)
        head = grel[head_key]
        checks[what] = {"loss_rel": lrel, "grad_rel": grel,
                        "worst": worst, "head_grad_rel": head}
        log("gluon, tier auto hybridized against %s: losses within %.3g "
            "relative over %d steps, step-1 gradients within %.3g of each "
            "tensor's largest magnitude (worst %s; the head %.3g)"
            % (what, lrel, len(want_l), grel[worst], worst, head))
        if not all(np.isfinite(loss_auto + want_l)) or lrel > 1e-4 \
                or grel[worst] > 1e-3:
            raise RuntimeError("gluon: tier auto hybridized disagrees with "
                               "%s: losses %g, gradients %g (%s)"
                               % (what, lrel, grel[worst], worst))
    del g_auto, g_off, g_eager
    torch.cuda.empty_cache()
    # -- one batch repeated six times: the loss falls
    gluon_load(net, p0)
    Xr, Yr = np.tile(X[:B_], (6, 1)), np.tile(Y[:B_], (6, 1))
    loss_rep, _w, _c, _g = gluon_train(net, Xr, Yr, ctx, 6, B_, True)
    log("gluon, one batch six times: losses %s"
        % ["%.5f" % v for v in loss_rep])
    if not loss_rep[-1] < loss_rep[0]:
        raise RuntimeError("gluon: the loss did not fall on a repeated "
                           "batch")
    # -- the numbers
    gluon_load(net, p0)
    net.hybridize(active=True)
    torch.cuda.reset_peak_memory_stats(dev)
    prof = gluon_step_profile(net, X, Y, ctx)
    peak = torch.cuda.max_memory_allocated(dev)
    del net
    torch.cuda.empty_cache()
    n_dense = nparam - P["vocab"] * P["dim"] - P["seq_len"] * P["dim"]
    T_ = P["seq_len"]
    attn_flops = 3 * 4 * B_ * P["heads"] * (T_ * (T_ + 1) // 2) \
        * (P["dim"] // P["heads"]) * L
    flops = 6 * n_dense * tokens + attn_flops
    fit_p50 = report["train"]["perf"]["step_ms_p50"]
    perf = {}
    for what, walls in (("hybridized_auto", wall_auto),
                        ("hybridized_off", wall_off),
                        ("eager_auto", wall_eager)):
        p50 = float(np.median(walls[1:]))
        perf[what] = {"step_ms": walls, "step_ms_p50": p50,
                      "tokens_per_s": tokens / (p50 / 1e3),
                      "model_flops_share_of_f32_peak":
                      flops / (p50 / 1e3) / F32_FLOPS}
    perf.update(module_fit_step_ms_p50=fit_p50, profile=prof,
                peak_memory_bytes=peak, model_flops_per_step=flops)
    log("gluon train step at GPT-2-small widths, batch 8 x 1024, f32, p50 "
        "over steps 2-N: hybridized tier auto %.2f ms (%.0f tokens/s, %.1f%% "
        "of the f32 peak), tier off %.2f ms, eager tier auto %.2f ms; "
        "Module.fit's step in this run (phase 8) %.2f ms; peak memory "
        "%.2f GB  [%s]"
        % (perf["hybridized_auto"]["step_ms_p50"],
           perf["hybridized_auto"]["tokens_per_s"],
           100 * perf["hybridized_auto"]["model_flops_share_of_f32_peak"],
           perf["hybridized_off"]["step_ms_p50"],
           perf["eager_auto"]["step_ms_p50"], fit_p50, peak / 1e9, card))
    log("gluon, one hybridized step at tier auto: forward with the loss "
        "%.2f ms, backward %.2f ms, update %.2f ms (CUDA events), wall "
        "%.2f ms; profiled: %.2f ms wall, %.2f ms device (busy %.1f%%), "
        "%d kernel launches, flash_attn.backward %.2f ms  [%s]"
        % (prof["forward_ms"], prof["backward_ms"], prof["update_ms"],
           prof["wall_ms"], prof["profiled_wall_ms"], prof["device_ms"],
           100 * prof["device_busy_share"], prof["kernel_launches"],
           prof["flash_attn_backward_ms"], card))
    log("gluon, top kernels of one step: " + "; ".join(
        "%s %.2f ms x%d" % (k["name"][:60], k["ms"], k["calls"])
        for k in prof["top_kernels"][:8]))
    report["gluon"].update(
        launches_auto=auto_counts, launches_off=off_counts,
        census_auto=census_auto, census_off=census_off,
        census_eager=census_eager, tier_stats_auto=auto_stats,
        losses_auto=loss_auto, losses_off=loss_off,
        losses_eager=loss_eager, losses_repeated=loss_rep,
        checks={k: {kk: vv for kk, vv in v.items() if kk != "grad_rel"}
                for k, v in checks.items()}, perf=perf)
    gluon_cut_depth(dev, report)
    return {"flash_attn": auto_counts["flash_attn"],
            "take_rows": auto_counts["take_rows"],
            "flash_fwd": off_counts["flash_fwd"]}


# ------------------------------------------------------ int8: the kernel
INT8_REPLACES = "mxnet_tpu/kernels/int8_dequant.py:40"
INT8_SOURCE = "mxnet_tpu_torch/csrc/int8_dequant.cu"
QUANT_OPS = ("_contrib_quantized_conv_int8", "_contrib_quantized_fc_int8")
INT8_RAGGED = (1001, 999)
IMAGE = (3, 224, 224)


def int8_sites(sym, args, aux):
    """The 54 quantized sites of ResNet-50 as the rewrite emits them
    (the shapes and activations do not depend on the calibration
    numbers, so unit ranges stand in): [{"name", "act", "in": per-image
    input shape, "out": per-image output shape, "params"}]."""
    sites, skipped = mt.quant.find_sites(sym, args)
    wamax = {s.name: np.abs(args[s.weight_name]).max(
        axis=tuple(range(1, args[s.weight_name].ndim))) for s in sites}
    calib = mt.quant.CalibrationResult(
        sites, skipped, {s.name: 1.0 for s in sites}, wamax, 1, 1)
    qsym = mt.quant.quantize_serving_graph(sym, args, aux, calib)[0]
    shapes = _infer_shapes(qsym, {"data": (1,) + IMAGE})
    out = []
    for n in qsym._topo():
        if n.is_variable or n.op.name not in QUANT_OPS:
            continue
        src, oi = n.inputs[0]
        key = ("var", src.name) if src.is_variable else (id(src), oi)
        out.append({"name": n.name, "act": n.params["act"],
                    "in": tuple(shapes[key][1:]),
                    "out": tuple(shapes[(id(n), 0)][1:]),
                    "params": dict(n.params)})
    acts = [s["act"] for s in out]
    if (len(out), acts.count("relu")) != (54, 33):
        raise RuntimeError("ResNet-50 int8 census: %d sites, %d ReLU; not "
                           "54 and 33" % (len(out), acts.count("relu")))
    return out


def acc_view(site, batch):
    """(rows, cols, hw) of a site's accumulator at ``batch``: the GEMM's
    column form (batch*OH*OW, O) for conv, (batch, O) for FC; hw is the
    per-row form's row length (OH*OW; 1 for FC)."""
    o = site["out"]
    hw = o[1] * o[2] if len(o) == 3 else 1
    return batch * hw, o[0], hw


def dequant_case(rows, cols, n_coef, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    acc = torch.randint(-2 ** 22, 2 ** 22, (rows, cols), generator=g,
                        device=dev, dtype=torch.int32)
    sc = torch.rand(n_coef, generator=g, device=dev) * 2e-3 - 5e-4
    sh = torch.randn(n_coef, generator=g, device=dev)
    return acc, sc, sh


def check_dequant(acc, sc, sh, per_row, act):
    """Kernel vs plain on the card: within one f32 ulp of the larger of
    |f32(acc) * sc| and |y| (both round the affine once; the plain
    version's f64 sum can round twice) -> (max abs err, bitwise-equal
    elements, elements); raises past it."""
    from mxnet_tpu_torch.kernels import int8_dequant as dq
    y = dq._launch(acc, sc, sh, per_row, act, dq.DEFAULT_CONFIG)
    ref = dq._plain_dequant(acc, sc, sh, per_row, act)
    torch.cuda.synchronize()
    C = sc.numel()
    coef = (sc.reshape(1, C, 1).expand(acc.shape[0] // C, C, 1)
            .reshape(-1, 1) if per_row else sc.reshape(1, -1))
    big = torch.maximum((acc.float() * coef).abs(), ref.abs())
    ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
    diff = (y.double() - ref.double()).abs()
    if not bool((diff <= ulp.double()).all()):
        raise RuntimeError("int8_dequant kernel disagrees with its plain "
                           "version at %s per_row=%s %s: max %g ulps"
                           % (tuple(acc.shape), per_row, act,
                              float((diff / ulp.double()).max())))
    return float(diff.max()), int((y == ref).sum()), y.numel()


def int8_bound_parts(rows, cols, n_coef):
    """Least time for one epilogue, as (bytes_ms, ops_ms): the int32
    accumulator read once, the f32 output written once, the two
    coefficient vectors read once, over the HBM rate; an FMA and a max
    (3 f32 flops) per element over the f32 peak."""
    n = rows * cols
    return ((8 * n + 8 * n_coef) / HBM_BYTES_PER_S * 1e3,
            3 * n / F32_FLOPS * 1e3)


def int8_kernel_phase(sites, dev):
    """B6 against its plain version at every distinct (accumulator shape,
    act) of the 54 sites, batch 1 and 32, in the column form the path
    uses and (conv sites) the per-row form at the same shapes, and at a
    ragged shape; the f32 times at batch 32; the card's int32
    accumulators against the CPU's at every conv shape and the FC."""
    from mxnet_tpu_torch.kernels import int8_dequant as dq
    from mxnet_tpu_torch.ops import quant_serve as qs
    classes = sorted({(s["out"], s["act"]) for s in sites})
    err = {"column": 0.0, "row": 0.0}
    equal = total = 0
    seed = 100
    for batch in (1, 32):
        for out, act in classes:
            site = next(s for s in sites if (s["out"], s["act"]) == (out,
                                                                     act))
            rows, cols, hw = acc_view(site, batch)
            forms = [("column", rows, cols, cols)]
            if hw > 1:   # NCHW viewed (batch*O, OH*OW), O coefficients
                forms.append(("row", batch * cols, hw, cols))
            for form, r, c, n_coef in forms:
                seed += 1
                acc, sc, sh = dequant_case(r, c, n_coef, dev, seed)
                e, eq, n = check_dequant(acc, sc, sh, form == "row", act)
                err[form] = max(err[form], e)
                equal += eq
                total += n
    for form, (r, c) in (("column", INT8_RAGGED), ("row", INT8_RAGGED)):
        acc, sc, sh = dequant_case(r, c, 7 if form == "row" else c, dev, 99)
        e, eq, n = check_dequant(acc, sc, sh, form == "row", "relu")
        err[form] = max(err[form], e)
        equal += eq
        total += n
    log("int8_dequant vs plain: %d (shape, act) classes x batch {1,32} x "
        "{column, row} + ragged %s agree within one f32 ulp; bitwise "
        "equal %d of %d (%.6f); max abs err %s"
        % (len(classes), INT8_RAGGED, equal, total, equal / total,
           json.dumps(err)))
    # times at batch 32, column form, per class as the path has them
    per_class = []
    for out, act in classes:
        n_sites = sum(1 for s in sites if (s["out"], s["act"]) == (out, act))
        site = next(s for s in sites if (s["out"], s["act"]) == (out, act))
        rows, cols, _ = acc_view(site, 32)
        acc, sc, sh = dequant_case(rows, cols, cols, dev, 7)
        k = time_ms(lambda: dq._launch(acc, sc, sh, False, act,
                                       dq.DEFAULT_CONFIG), dev)
        p = time_ms(lambda: dq._plain_dequant(acc, sc, sh, False, act), dev)
        bytes_ms, ops_ms = int8_bound_parts(rows, cols, cols)
        b, by = bound_of(bytes_ms, ops_ms)
        per_class.append({"shape": [rows, cols], "act": act,
                          "sites": n_sites, "kernel_ms": k, "plain_ms": p,
                          "bytes_ms": bytes_ms, "ops_ms": ops_ms,
                          "bound_ms": b, "bound_by": by,
                          "roofline_share": b / k})
        log("  int8_dequant %-14s %-8s sites=%-2d kernel_ms=%.5f "
            "plain_ms=%.5f bound_ms=%.5f (%s) share=%.3f"
            % ((rows, cols), act, n_sites, k, p, b, by, b / k))
        del acc
    tot = {key: sum(r[key] * r["sites"] for r in per_class)
           for key in ("kernel_ms", "plain_ms", "bytes_ms", "ops_ms")}
    tot["bound_ms"], tot["bound_by"] = bound_of(tot["bytes_ms"],
                                                tot["ops_ms"])
    log("  batch-32 forward, 54 int8_dequant launches: kernel_ms=%.4f "
        "plain_ms=%.4f bound_ms=%.4f (%s)"
        % (tot["kernel_ms"], tot["plain_ms"], tot["bound_ms"],
           tot["bound_by"]))
    # the int8 product: the card's accumulators are the CPU's, bitwise
    g = torch.Generator().manual_seed(5)
    configs = sorted({(s["in"], s["out"][0],
                       tuple(s["params"].get("kernel") or ()),
                       tuple(s["params"].get("stride") or ()),
                       tuple(s["params"].get("pad") or ())) for s in sites})
    for cin, O, kernel, stride, pad in configs:
        xq = torch.randint(-127, 128, (1,) + cin, generator=g,
                           dtype=torch.int8)
        K = int(np.prod(cin[:1] + kernel)) if kernel else cin[0]
        w = torch.randint(-127, 128, (O, K), generator=g, dtype=torch.int8)
        accs = []
        for d in ("cpu", dev):
            x = xq.to(d)
            p = (qs._patches(x, kernel, stride or (1, 1), pad or (0, 0),
                             (1, 1)) if kernel else x)
            accs.append(qs._int8_matmul(p, w.to(d)).cpu())
        if not torch.equal(accs[0], accs[1]):
            raise RuntimeError("int32 accumulators of the int8 product "
                               "differ between the card and the CPU at %s"
                               % ((cin, O, kernel, stride, pad),))
    log("int8 product (torch._int_mm): the card's int32 accumulators equal "
        "the CPU's at all %d site shapes (batch 1)" % len(configs))
    return err, per_class, tot


# --------------------------------------------------- int8: the main path
def int8_burst(srv, inputs):
    """Submit every (dtype, input) from its own thread at once; every
    request must be answered with valid softmax rows."""
    reqs = [None] * len(inputs)
    errors = []

    def submit(i):
        dtype, x = inputs[i]
        try:
            reqs[i] = srv.submit(data=x, dtype=dtype, timeout_ms=300000)
        except Exception as e:  # reported below, never swallowed
            errors.append(e)
    threads = [threading.Thread(target=submit, args=(i,))
               for i in range(len(inputs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    if errors:
        raise errors[0]
    outs = [r.result(timeout=600)[0] for r in reqs]
    for out, (_, x) in zip(outs, inputs):
        check_answer(out, x.shape[0])
    return outs


def int8_profile(model, dev, batch, reps=3):
    """torch.profiler over ``reps`` forwards of the int8 model: the
    device busy share, and the device time of B6 (its kernels), of the
    int8 GEMM (``aten::_int_mm``), of quantize + im2col (named ranges
    put around ``_quantize_static``, ``_patches`` and ``_int8_matmul``
    for this pass only, less the GEMM) and of the rest. A range's and an
    op's device time is the sum of the kernels launched inside it (its
    host-side event); the ranges' device-side spans also count the idle
    gaps between their kernels and are left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from mxnet_tpu_torch.ops import quant_serve as qs
    names = {"_quantize_static": "int8.quantize", "_patches": "int8.patches",
             "_int8_matmul": "int8.matmul"}
    saved = {f: getattr(qs, f) for f in names}

    def ranged(fn, label):
        def wrapped(*a, **k):
            with record_function(label):
                return fn(*a, **k)
        return wrapped
    x = torch.randn((batch,) + IMAGE, device=dev)
    model.run(x)
    torch.cuda.synchronize()
    try:
        for f, label in names.items():
            setattr(qs, f, ranged(saved[f], label))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(reps):
                model.run(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for f, fn in saved.items():
            setattr(qs, f, fn)
    avgs = prof.key_averages()
    labels = set(names.values())
    host = {e.key: e.device_time_total for e in avgs
            if e.device_type == DeviceType.CPU
            and e.key in labels | {"aten::_int_mm"}}
    kernels = [(e.key, e.self_device_time_total, e.count) for e in avgs
               if e.device_type == DeviceType.CUDA and e.key not in labels]
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    b6 = sum(k[1] for k in kernels if "int8_dequant" in k[0])
    mm = host.get("aten::_int_mm", 0.0)
    qi = sum(host.get(lb, 0.0) for lb in labels) - mm
    if min(b6, mm, qi, busy - b6 - mm - qi) < 0 or mm <= 0 or b6 <= 0:
        raise RuntimeError("int8 profile parts do not add up: busy %g, "
                           "int8_dequant %g, _int_mm %g, quantize + im2col "
                           "%g (us)" % (busy, b6, mm, qi))
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    per = reps * 1e3
    return {"batch": batch, "wall_ms_per_forward": wall_us / per,
            "device_ms_per_forward": busy / per,
            "device_busy_share": busy / wall_us,
            "int8_dequant_ms": b6 / per, "int_mm_ms": mm / per,
            "quantize_im2col_ms": qi / per,
            "rest_ms": (busy - b6 - mm - qi) / per,
            "top_kernels": [{"name": k[0][:120], "ms_per_forward":
                             k[1] / per, "calls": k[2] // reps}
                            for k in top]}


def int8_main_path(dev, card, report, f32_path, sym, args, aux):
    """ResNet-50 calibrated on the card, exported as a format-4 artifact
    and served beside its f32 twin at ``f32_path``; returns B6's
    launches."""
    from mxnet_tpu_torch.kernels import int8_dequant as dq
    rng = np.random.RandomState(2)
    calib = [rng.randn(8, *IMAGE).astype("f4") for _ in range(4)]
    qpath = os.path.join(REPO, "build", "chip_smoke", "resnet50.int8.mxtorch")
    t0 = time.perf_counter()
    qmeta = mt.quant.export_quantized(sym, args, aux, calib,
                                      {"data": (None,) + IMAGE}, qpath,
                                      device=dev)
    rep = qmeta["quant"]
    wb = rep["weight_bytes"]
    log("calibrate (4 batches of 8 on the card) + rewrite + export: %.2fs, "
        "%.1f MB (f32 artifact %.1f MB); %d sites, skipped %s; weight "
        "bytes int8 %d / f32 %d = %.4f; fingerprint %s; kernel_tier %s"
        % (time.perf_counter() - t0, os.path.getsize(qpath) / 1e6,
           os.path.getsize(f32_path) / 1e6, len(rep["sites"]),
           rep["skipped"], wb["int8"], wb["f32"], wb["int8"] / wb["f32"],
           rep["calibration"]["fingerprint"][:16],
           json.dumps(qmeta["kernel_tier"])))
    if len(rep["sites"]) != 54 or rep["skipped"]:
        raise RuntimeError("quantized %d sites (skipped %s), not 54"
                           % (len(rep["sites"]), rep["skipped"]))
    if wb["int8"] > 0.3 * wb["f32"]:
        raise RuntimeError("int8 weight payload is %.3f of the f32 one"
                           % (wb["int8"] / wb["f32"]))
    rng = np.random.RandomState(3)
    mixed = []
    for dtype in ("f32", "int8"):
        mixed += [(dtype, rng.randn(1, *IMAGE).astype("f4"))
                  for _ in range(6)]
        mixed += [(dtype, rng.randn(b, *IMAGE).astype("f4"))
                  for b in (8, 32)]

    # -- the main path, with every count zeroed just before it
    tier.reset_stats()
    bn_act.reset_launches()
    dq.reset_launches()
    srv = mt.serve.Server(f32_path, quantized=qpath, buckets=BUCKETS,
                          batch_timeout_ms=2)
    outs = int8_burst(srv, mixed)
    # the burst may coalesce into bucket 32 alone: one image and one
    # batch of 8 of each dtype, each sent alone, take buckets 1 and 8
    for dtype, i in (("f32", 0), ("f32", 6), ("int8", 8), ("int8", 14)):
        x = mixed[i][1]
        mixed.append((dtype, x))
        outs.append(srv.predict(data=x, dtype=dtype, timeout_ms=300000)[0])
        check_answer(outs[-1], x.shape[0])
    torch.cuda.synchronize()
    launches = dict(dq.launches_by_kernel)
    bn_launches = bn_act.launches
    stats = tier.stats()
    est = srv.model.engine_cache.stats()
    fwd = {"f32": 0, "int8": 0}
    for e in est["engines"].values():
        fwd[e["dtype"]] += 1 + e["calls"]      # the warmup, then calls
    log("int8 main path: %d requests answered (f32 and int8 mixed), "
        "forwards %s (engines %s), int8_dequant launches %s, bn_act %d, "
        "tier %s" % (len(outs), fwd, sorted(est["engines"]), launches,
                     bn_launches, json.dumps(stats["dispatch"])))
    want = {"column/relu": 33 * fwd["int8"],
            "column/identity": 21 * fwd["int8"], "row/relu": 0,
            "row/identity": 0}
    if launches != want or dq.launches != 54 * fwd["int8"]:
        raise RuntimeError("expected 54 int8_dequant launches per int8 "
                           "forward (33 ReLU, 21 identity) over %d "
                           "forwards, got %s" % (fwd["int8"], launches))
    if bn_launches != 49 * fwd["f32"]:
        raise RuntimeError("expected 49 bn_act launches per f32 forward "
                           "over %d forwards, got %d"
                           % (fwd["f32"], bn_launches))
    if stats["fallback"]:
        raise RuntimeError("kernel tier fell back: %s" % stats["fallback"])
    served = sorted(est["engines"])
    if served != sorted([str(b) for b in BUCKETS]
                        + ["int8:%d" % b for b in BUCKETS]):
        raise RuntimeError("engines served: %s" % served)

    # -- int8 against the same artifact at tier off on the card, f32
    # against int8. Tolerance 1e-5 on probabilities: every integer part
    # is exact and both epilogues round once, so the answers are equal
    # up to ulps unless an f32 value lands on an int8 rounding tie and
    # moves one quantized input by one step
    i8 = [k for k, (d, _) in enumerate(mixed) if d == "int8"]
    with mt.config.override(kernel_tier="off"):
        m_off = mt.serving.CompiledModel.load(qpath, device=dev)
    err_off = max(float(np.abs(outs[k] - m_off.predict(data=mixed[k][1])[0]
                               .cpu().numpy()).max()) for k in i8)
    log("int8 tier auto vs off on the card: max abs err %g" % err_off)
    if err_off > 1e-5:
        raise RuntimeError("int8 answers disagree with tier off")
    m_f32 = mt.serving.CompiledModel.load(f32_path, device=dev)
    p8 = np.concatenate([outs[k] for k in i8])
    p32 = np.concatenate([m_f32.predict(data=mixed[k][1])[0].cpu().numpy()
                          for k in i8])
    dp = np.abs(p8 - p32)
    top2 = np.sort(p32, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    agree = p8.argmax(1) == p32.argmax(1)
    clear = margin > 2 * dp.max(axis=1)
    log("int8 vs f32 on %d images: top-1 agreement %.4f (%d of %d), max "
        "|dp| %g (f32 max p %g); %d rows with a top-1/top-2 margin above "
        "twice their |dp|, all of them agree: %s"
        % (len(agree), agree.mean(), agree.sum(), len(agree), dp.max(),
           p32.max(), clear.sum(), bool(agree[clear].all())))
    if not agree[clear].all():
        raise RuntimeError("int8 changed the top-1 class of a row whose "
                           "f32 margin exceeds the int8 error")

    # -- latency per bucket and dtype (closed loop, one request in flight)
    lat = {}
    for dtype in ("f32", "int8"):
        for b in BUCKETS:
            x = np.random.RandomState(b).randn(b, *IMAGE).astype("f4")
            samples = []
            t_all = time.perf_counter()
            for _ in range(20):
                t1 = time.perf_counter()
                check_answer(srv.predict(data=x, dtype=dtype,
                                         timeout_ms=300000)[0], b)
                samples.append((time.perf_counter() - t1) * 1e3)
            wall = time.perf_counter() - t_all
            lat["%s/%d" % (dtype, b)] = {
                "p50_ms": float(np.percentile(samples, 50)),
                "p99_ms": float(np.percentile(samples, 99)),
                "img_per_s": 20 * b / wall}
            r = lat["%s/%d" % (dtype, b)]
            log("%-4s bucket %2d: p50 %.3f ms  p99 %.3f ms  %.1f img/s  [%s]"
                % (dtype, b, r["p50_ms"], r["p99_ms"], r["img_per_s"], card))
    server_metrics = srv.metrics()
    srv.close()

    # -- the eager forward at batch 1 and 32, int8 / f32 / f32 / int8
    m_i8 = mt.serving.CompiledModel.load(qpath, device=dev)
    fwd_ms = {}
    for b in (1, 32):
        a1, f1 = forward_ms(m_i8, dev, b), forward_ms(m_f32, dev, b)
        f2, a2 = forward_ms(m_f32, dev, b), forward_ms(m_i8, dev, b)
        fwd_ms[str(b)] = {"int8_ms": [a1, a2], "f32_ms": [f1, f2]}
        log("batch-%d forward: int8 %.3f / %.3f ms, f32 %.3f / %.3f ms  "
            "[%s]" % (b, a1, a2, f1, f2, card))
    prof = {}
    for b in (1, 32):
        p = int8_profile(m_i8, dev, b)
        prof[str(b)] = p
        log("profile int8 batch %d: wall %.3f ms, device %.3f ms (busy "
            "%.1f%%): int8_dequant %.3f ms, _int_mm %.3f ms, quantize + "
            "im2col %.3f ms, rest %.3f ms; top: %s"
            % (b, p["wall_ms_per_forward"], p["device_ms_per_forward"],
               100 * p["device_busy_share"], p["int8_dequant_ms"],
               p["int_mm_ms"], p["quantize_im2col_ms"], p["rest_ms"],
               "; ".join("%s %.3f ms x%d" % (k["name"][:48],
                                            k["ms_per_forward"], k["calls"])
                         for k in p["top_kernels"][:5])))
    # -- one image on the CPU, last (same tolerance and reason as above)
    cpu = mt.serving.CompiledModel.load(qpath, device="cpu")
    ref = cpu.predict(data=mixed[i8[0]][1])[0].numpy()
    err_cpu = float(np.abs(outs[i8[0]] - ref).max())
    log("int8 served on the card vs the CPU (one image): max abs err %g"
        % err_cpu)
    if err_cpu > 1e-5:
        raise RuntimeError("int8 answers disagree with the CPU")
    report.update(int8_path={
        "launches": launches, "forwards": fwd, "bn_act_launches":
        bn_launches, "tier_stats": stats, "engines": est,
        "weight_bytes": wb, "err_vs_off": err_off, "err_vs_cpu": err_cpu,
        "top1_agreement": float(agree.mean()), "max_dp_vs_f32":
        float(dp.max()), "latency": lat, "forward": fwd_ms,
        "profile": prof, "server": server_metrics})
    return sum(launches.values())


# ------------------------------------------ ResNet-50 training: the kernel
# forward + backward model FLOPs of one ResNet-50 image at 224x224, as the
# JAX package's perfmodel counts them (3 x 2 x 4.089 GFLOP multiply-adds)
RESNET50_TRAIN_FLOPS_PER_IMG = 3 * 2 * 4.089e9
RESNET_TRAIN = dict(bf16_batch=128, bf16_steps=10, f32_batch=32, f32_steps=8,
                    cut_batch=2)
# bench.py's fit leg: SGD with momentum, bf16 compute over f32 masters
RESNET_SGD = {"learning_rate": 0.05, "momentum": 0.9}
# the parameters between the last BatchNorm and the loss
HEAD = ("fc1_weight", "fc1_bias")


def b1_train_phase(sites, dev, batch=RESNET_TRAIN["bf16_batch"],
                   dtype=torch.bfloat16):
    """B1 against its plain version at every site class of the bf16
    training forward (batch 128; or ``batch`` in ``dtype``), then the
    device times per class and summed over the 49 sites, beside the
    bound (the dtype's bytes over 3.35 TB/s)."""
    dt = str(dtype).replace("torch.", "")
    rows = [b1_class_row(form, (batch,) + chw, dtype,
                         sites.count((form, chw)), dev, 100 + i, "train ")
            for i, (form, chw) in enumerate(sorted(set(sites)))]
    max_err = {}
    for r in rows:
        max_err[r["form"]] = max(max_err.get(r["form"], 0.0),
                                 r["max_abs_err"])
    totals = {form: b1_totals([r for r in rows if form in ("all",
                                                           r["form"])],
                              "batch-%d %s training forward, %s"
                              % (batch, dt, form))
              for form in ("bn_act", "bn_act_res", "all")}
    log("B1 vs plain at the batch-%d %s training shapes: %d site classes "
        "agree; max abs err %s" % (batch, dt, len(rows),
                                   json.dumps(max_err)))
    return max_err, rows, totals


# -------------------------------------- ResNet-50 training: the main path
class OneBatchIter(mt.io.DataIter):
    """bench.py's ``_OneBatchIter``: one batch, already on the card,
    served ``steps`` times an epoch."""

    def __init__(self, X, Y, steps, dev):
        super().__init__(X.shape[0])
        self.batch = mt.io.DataBatch(
            data=[torch.from_numpy(X).to(dev)],
            label=[torch.from_numpy(Y).to(dev)])
        self.steps, self.n = steps, 0
        self.provide_data = [mt.io.DataDesc("data", X.shape)]
        self.provide_label = [mt.io.DataDesc("softmax_label", Y.shape)]

    def reset(self):
        self.n = 0

    def next(self):
        if self.n >= self.steps:
            raise StopIteration
        self.n += 1
        return self.batch


def image_batch(batch, seed=0, chw=(3, 224, 224)):
    """bench.py's fit batch: randn images and randint(0, 1000) labels
    from RandomState(seed)."""
    rng = np.random.RandomState(seed)
    X = rng.randn(batch, *chw).astype(np.float32)
    Y = rng.randint(0, 1000, (batch,)).astype(np.float32)
    return X, Y


def resnet_init(sym, dev, chw=(3, 224, 224), rnd_type="uniform"):
    """bench.py's initializer, Xavier(factor_type="in", magnitude=2),
    drawn once on ``dev`` (seed 0) -> (args, aux) on the CPU;
    train_imagenet.py's draws it ``rnd_type="gaussian"``."""
    init = mt.mod.Module(sym, context=dev)
    init.bind([("data", (2,) + tuple(chw))], [("softmax_label", (2,))])
    init.init_params(mt.init.Xavier(rnd_type=rnd_type, factor_type="in",
                                    magnitude=2.0, seed=0))
    args, aux = init.get_params()
    return ({k: v.cpu() for k, v in args.items()},
            {k: v.cpu() for k, v in aux.items()})


def resnet_fit(sym, X, Y, dev, steps, p0, aux0, mp, k=1, epochs=1,
               sgd=RESNET_SGD, seed=None):
    """``Module.fit`` as bench.py's fit leg calls it (SGD lr 0.05,
    momentum 0.9, ``multi_precision`` when ``mp``, kvstore tpu_sync,
    ``steps_per_dispatch=1``, no metric) over one batch repeated
    ``steps`` times -> (module, losses, host stamps). After every step
    the loss (mean cross-entropy of the outputs at the labels, read on
    the card) is recorded and every master weight must be f32.

    ``examples/train_imagenet.py --benchmark 1`` is the same call with
    ``sgd=IMAGENET_SGD`` (wd 1e-4), ``epochs`` epochs and
    ``steps_per_dispatch=k``; ``seed`` seeds the key chain first (the
    dropout masks). At K > 1 no step's loss is read: the losses are the
    windows' stacked outputs and the stamps are the start and each
    epoch's end, the card synchronized."""
    mod = mt.mod.Module(sym, context=dev)
    losses, stamps = [], []
    it = OneBatchIter(X, Y, steps, dev)
    lab = it.batch.label[0].long()

    def record(_p):
        out = mod.get_outputs()[0].float()
        pick = out.gather(1, lab.unsqueeze(1)).clamp_min(1e-30)
        losses.append(float(-pick.log().mean()))   # syncs the card
        stamps.append(time.perf_counter())
        bad = [k_ for k_, v in mod._exec.arg_dict.items()
               if k_ not in ("data", "softmax_label")
               and v.dtype != torch.float32]
        if bad:
            raise RuntimeError("master weights left f32: %s" % bad[:3])

    def epoch_end(_epoch, _sym, _arg, _aux):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
    if seed is not None:
        mt.random.seed(seed)
    if k > 1:
        losses = window_recorder(mod)
    stamps.append(time.perf_counter())
    mod.fit(it, num_epoch=epochs, eval_metric=None, kvstore="tpu_sync",
            optimizer="sgd",
            optimizer_params=dict(sgd, multi_precision=mp),
            arg_params=p0, aux_params=aux0, steps_per_dispatch=k,
            batch_end_callback=record if k == 1 else None,
            epoch_end_callback=epoch_end if k > 1 else None)
    want = torch.bfloat16 if mp else None
    if mod._fused is None or mod._fused.compute_dtype != want:
        raise RuntimeError("fit did not take the fused step in %s"
                           % (want or "f32"))
    return mod, losses, stamps


def falling(losses):
    """Every loss finite, and the lowest after the first update below the
    first: SGD at lr 0.05 with momentum 0.9 from these weights swings
    over a repeated batch (at batch 16 and 32 the loss rises again
    within 3-5 steps before it falls), so the last step alone does not
    say whether the updates descend."""
    return bool(np.isfinite(losses).all()) and min(losses[1:]) < losses[0]


def check_moving_stats(mod, aux0):
    """Every moving statistic f32, and moved from its initial value."""
    aux = mod.get_params()[1]
    bad = [k for k, v in aux.items() if v.dtype != torch.float32]
    still = [k for k, v in aux.items() if torch.equal(v.cpu(), aux0[k])]
    if bad or still:
        raise RuntimeError("moving statistics: not f32 %s, not moved %s"
                           % (bad[:3], still[:3]))
    return len(aux)


def resnet_grads(sym, p0, aux0, X, Y, dev, tier_val, mp):
    """One step's softmax outputs and gradients with respect to the f32
    masters, through the Module's fused step (bf16 compute under
    ``mp``), at ``p0`` on (X, Y) -> (outputs, {name: tensor on dev})."""
    with mt.config.override(kernel_tier=tier_val):
        mod = mt.mod.Module(sym, context=dev)
        mod.bind([("data", X.shape)], [("softmax_label", Y.shape)])
        mod.init_params(arg_params=p0, aux_params=aux0)
        mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                           optimizer_params=dict(RESNET_SGD,
                                                 multi_precision=mp))
        mod._exec.set_inputs(data=X, softmax_label=Y)
        outs, _aux, leaves = mod._fused.forward()
        grads = mod._fused.backward(outs, leaves)
    return (outs[0].detach().float(),
            {k: v.detach() for k, v in grads.items()})


def perturbed(X, rel, seed=0):
    """X with every element moved by a relative ``rel`` times N(0, 1): a
    rounding's worth of change, to measure how far the model's own
    gradients and losses move under one."""
    noise = np.random.RandomState(seed).randn(*X.shape).astype(np.float32)
    return (X * (1 + rel * noise)).astype(np.float32)


def rel_l2(got, want):
    """Per tensor: the relative L2 error of got against want."""
    return {k: float((got[k].to(want[k].device).float() - want[k].float())
                     .norm() / want[k].float().norm().clamp_min(1e-30))
            for k in want}


def relu_inputs(sym, params, aux, X, dev):
    """The input of every ReLU of the graph at ``params`` on X, f32, tier
    off (BatchNorm with batch statistics), on the CPU ->
    {relu name: tensor}; and for each parameter the ReLUs next to it:
    the one feeding its op and those its op's output reaches through at
    most one more op."""
    from mxnet_tpu_torch.symbol.symbol import Symbol
    nodes = sym._topo()
    relus = [n for n in nodes if not n.is_variable
             and n.op.name == "Activation"]
    relu_ids = {id(n) for n in relus}
    consumers = {}
    for n in nodes:
        for (src, _oi) in n.inputs:
            consumers.setdefault(id(src), []).append(n)
    near = {}
    for n in nodes:
        if n.is_variable:
            continue
        ids = set()
        data = n.inputs[0][0] if n.inputs else None
        if data is not None and id(data) in relu_ids:
            ids.add(data.name)
        for c in consumers.get(id(n), []):
            if id(c) in relu_ids:
                ids.add(c.name)
            for c2 in consumers.get(id(c), []):
                if id(c2) in relu_ids:
                    ids.add(c2.name)
        for (src, _oi) in n.inputs[1:]:
            if src.is_variable:
                near[src.name] = sorted(ids)
    with mt.config.override(kernel_tier="off"):
        ex = Symbol([r.inputs[0] for r in relus]).simple_bind(
            dev, grad_req="null", data=tuple(X.shape))
    ex.copy_params_from(params, aux, allow_extra_params=True)
    outs = ex.forward(is_train=True, data=X)
    return {r.name: o.cpu() for r, o in zip(relus, outs)}, near


def resnet_card_vs_cpu(sym, p0, aux0, dev, report, what="ResNet-50",
                       key="resnet_train", chw=(3, 224, 224),
                       batch=RESNET_TRAIN["cut_batch"], seed=None):
    """ResNet-50 at batch 2 (224x224), one step on the card against the
    CPU (the kernels' plain versions), tier auto, f32 and bf16; any other
    model ``what`` of the same head at ``chw`` and ``batch`` (results
    under ``report[key]``), with the key chain seeded ``seed`` before
    each step where it has dropout.

    The forward is well conditioned: f32 softmax outputs within a
    relative L2 error of 1e-4 (the CPU against itself at another thread
    count: 2.4e-6), or of twice what the perturbation below does to the
    CPU's own outputs where that is more (Inception-v3 at 139 px and
    batch 2 leaves ReLU inputs within rounding of 0 that may flip); bf16
    outputs within twice the CPU's own bf16-vs-f32 error. The backward is not. At these Xavier weights the gradient
    norms grow from 1.4 (``fc1_bias``) to 518 (``conv0_weight``) going
    back through the 53 BatchNorms, and so does rounding: a relative
    change of 1e-7 in the images moves the CPU's own f32 gradients by
    1-2 % (relative L2) below the last stage, the JAX package and the
    port on the CPU part by the same 1.7 %, and a bf16 step's gradients
    there are ~130 % from the f32 step's in both packages, as far as two
    unrelated draws. So:

    - f32: the head's gradients within a relative L2 error of 1e-4, and
      the median over all tensors within twice what that perturbation
      does to the CPU's own (per tensor it is no bound: near the head
      the sensitivity is 1e-4 to 1e-3, and one flipped ReLU input moves
      a tensor by more); each tensor's largest error over its largest
      magnitude is printed, with the ReLU inputs of opposite sign, card
      against CPU and CPU against the perturbed CPU: the flips behind
      the outliers;
    - bf16: the head's gradients (``fc1_weight``, ``fc1_bias``: no
      BatchNorm between them and the loss) within twice the CPU's own
      bf16-vs-f32 error; below the head the medians are printed, not
      held (bf16 rounding alone makes them unrelated draws)."""
    B_ = batch
    X, Y = image_batch(B_, seed=3, chw=chw)
    Xp = perturbed(X, 1e-7)

    def grads(x, d, mp):
        if seed is not None:
            mt.random.seed(seed)
        return resnet_grads(sym, p0, aux0, x, Y, d, "auto", mp)
    run = {}
    for d in (dev, "cpu"):
        for mp in (False, True):
            run[(str(d), mp)] = grads(X, d, mp)
    run["cpu_perturbed"] = grads(Xp, "cpu", False)
    card, cpu = str(dev), "cpu"

    def out_err(a, b):
        return float((run[a][0].cpu() - run[b][0]).norm()
                     / run[b][0].norm())
    o32 = out_err((card, False), (cpu, False))
    o32_own = out_err("cpu_perturbed", (cpu, False))
    o16 = out_err((card, True), (cpu, True))
    o16_own = out_err((cpu, True), (cpu, False))
    g = {k: v[1] for k, v in run.items()}
    e32 = rel_l2(g[(card, False)], g[(cpu, False)])
    e32_own = rel_l2(g["cpu_perturbed"], g[(cpu, False)])
    e16 = rel_l2(g[(card, True)], g[(cpu, True)])
    e16_own = rel_l2(g[(cpu, True)], g[(cpu, False)])
    med = {n: float(np.median(list(e.values()))) for n, e in
           (("f32", e32), ("f32_own", e32_own), ("bf16", e16),
            ("bf16_own", e16_own))}
    maxrel = {k: float((g[(card, False)][k].cpu() - v).abs().max()
                       / v.abs().max().clamp_min(1e-30))
              for k, v in g[(cpu, False)].items()}
    worst = sorted(maxrel, key=maxrel.get)[-3:]
    pre_cpu, near = relu_inputs(sym, p0, aux0, X, "cpu")
    pre_card = relu_inputs(sym, p0, aux0, X, dev)[0]
    pre_pert = relu_inputs(sym, p0, aux0, Xp, "cpu")[0]
    flips = {n: int(((a > 0) != (pre_card[n] > 0)).sum())
             for n, a in pre_cpu.items()}
    flips_own = {n: int(((a > 0) != (pre_pert[n] > 0)).sum())
                 for n, a in pre_cpu.items()}
    near_worst = {k: {r: flips[r] for r in near.get(k, [])}
                  for k in worst}
    log("%s at batch %d and %dx%d, one step, card vs CPU: outputs f32 %.3g "
        "(the CPU against itself at images x (1 + 1e-7 noise): %.3g), "
        "bf16 %.3g (CPU bf16 vs f32 %.3g) relative L2; head gradients f32 "
        "%s, bf16 %s (CPU bf16 vs f32 %s); gradients, median "
        "relative L2 over tensors: f32 %.4g (the CPU against itself at "
        "images x (1 + 1e-7 noise): %.4g), bf16 %.4g (CPU bf16 vs f32 "
        "%.4g); f32 largest error over largest magnitude %s; ReLU inputs "
        "of opposite sign, card vs CPU %d elements at %d of %d sites "
        "(CPU vs perturbed CPU %d at %d), near the worst tensors %s"
        % (what, B_, chw[1], chw[2], o32, o32_own, o16, o16_own,
           json.dumps({k: float("%.3g" % e32[k]) for k in HEAD}),
           json.dumps({k: float("%.3g" % e16[k]) for k in HEAD}),
           json.dumps({k: float("%.3g" % e16_own[k]) for k in HEAD}),
           med["f32"], med["f32_own"], med["bf16"],
           med["bf16_own"], ", ".join("%s %.3g" % (k, maxrel[k])
                                      for k in reversed(worst)),
           sum(flips.values()), sum(1 for v in flips.values() if v),
           len(flips), sum(flips_own.values()),
           sum(1 for v in flips_own.values() if v),
           json.dumps(near_worst)))
    report[key].update(
        card_vs_cpu={"outputs_rel_l2": {"f32": o32, "f32_own": o32_own,
                                        "bf16": o16,
                                        "cpu_bf16_vs_f32": o16_own},
                     "grad_median_rel_l2": med,
                     "grad_rel_l2_f32": e32, "grad_rel_l2_bf16": e16,
                     "grad_maxrel_f32": maxrel, "relu_flips": flips,
                     "relu_flips_cpu_perturbed": flips_own})
    if o32 > max(1e-4, 2 * o32_own) or o16 > 2 * o16_own:
        raise RuntimeError("%s card and CPU outputs disagree: f32 %g (own "
                           "%g), bf16 %g (CPU bf16 vs f32 %g)"
                           % (what, o32, o32_own, o16, o16_own))
    bad = {"f32 head": {k: e32[k] for k in HEAD if e32[k] > 1e-4},
           "bf16 head": {k: e16[k] for k in HEAD
                         if e16[k] > 2 * e16_own[k]}}
    if med["f32"] > 2 * med["f32_own"] or bad["f32 head"] \
            or bad["bf16 head"]:
        raise RuntimeError("%s card and CPU gradients disagree past the "
                           "model's own rounding sensitivity: medians %s, "
                           "%s" % (what, json.dumps(med), json.dumps(bad)))


def kernel_class(name):
    """The part of a training step a device kernel belongs to."""
    n = name.lower()
    if "bn_act" in n:
        return "B1"
    if "nchwtonhwc" in n or "nhwctonchw" in n:
        return "layout transposes"
    if any(t in n for t in ("cudnn", "xmma", "gemm", "conv", "grad",
                            "sm90", "sm80", "cutlass", "fprop")):
        return "convolutions and GEMMs"
    if "reduce" in n:
        return "reductions"
    return "elementwise and copies"


def resnet_step_profile(mod, steps=3):
    """One fused step at the module's bound batch (inputs already set):
    forward, backward and update timed with CUDA events (median of
    ``steps``), then torch.profiler over one more step: busy share, B1's
    device time, the device time by kind of kernel (``kernel_class``),
    the named ranges (the batch statistics, the recomputed B1 backward,
    the low-precision BatchNorm backward: the device time the profiler
    gives each range, which nests and is not additive) and the top
    kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fused = mod._fused
    parts = []
    for _ in range(steps):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev[0].record()
        outs, auxu, leaves = fused.forward()
        ev[1].record()
        grads = fused.backward(outs, leaves)
        ev[2].record()
        fused.apply(grads, mod._fused_opt_state)
        ev[3].record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        parts.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                      ev[2].elapsed_time(ev[3]), wall))
        del outs, auxu, leaves, grads
    med = [float(np.median([p[i] for p in parts])) for i in range(4)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fused.step(mod._fused_opt_state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    names = ("bn_act.coefs", "bn_act.backward", "batch_norm.lowp_backward")
    ranges = {e.key: e.device_time_total / 1e3 for e in avgs
              if e.key in names}
    kernels = [(e.key, e.self_device_time_total, e.count) for e in avgs
               if e.device_type == DeviceType.CUDA and e.key not in names]
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    b1 = [k for k in kernels if "bn_act" in k[0]]
    top = sorted(kernels, key=lambda k: -k[1])[:12]
    classes = {}
    for k in kernels:
        c = kernel_class(k[0])
        classes[c] = classes.get(c, 0.0) + k[1] / 1e3
    return {"forward_ms": med[0], "backward_ms": med[1], "update_ms": med[2],
            "classes_ms": classes,
            "wall_ms": med[3], "profiled_wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3, "device_busy_share": busy / wall_us,
            "b1_ms": sum(k[1] for k in b1) / 1e3,
            "b1_launches": sum(k[2] for k in b1),
            "ranges_ms": {n: ranges.get(n, 0.0) for n in names},
            "top_kernels": [{"name": k[0][:110], "ms": k[1] / 1e3,
                             "calls": k[2]} for k in top]}


def log_step(what, steps_ms, batch, flops_peak, prof, mem, card,
             flops_per_img=RESNET50_TRAIN_FLOPS_PER_IMG):
    p50 = float(np.median(steps_ms))
    flops = flops_per_img * batch
    share = flops / (p50 / 1e3) / flops_peak[1]
    log("%s: step p50 %.2f ms over steps 2-%d, %.1f images/s, %.3f TFLOP "
        "model FLOPs a step = %.1f%% of the %s peak; peak memory %.2f GB  "
        "[%s]" % (what, p50, len(steps_ms) + 1, batch / (p50 / 1e3),
                  flops / 1e12, 100 * share, flops_peak[0], mem / 1e9,
                  card))
    log("  one step: forward %.2f ms, backward %.2f ms, update %.2f ms (CUDA "
        "events), wall %.2f ms; profiled: %.2f ms wall, %.2f ms device (busy "
        "%.1f%%); B1 %d launches, %.3f ms; ranges %s"
        % (prof["forward_ms"], prof["backward_ms"], prof["update_ms"],
           prof["wall_ms"], prof["profiled_wall_ms"], prof["device_ms"],
           100 * prof["device_busy_share"], prof["b1_launches"],
           prof["b1_ms"], json.dumps({k: round(v, 3) for k, v in
                                      prof["ranges_ms"].items()})))
    log("  device time by kind (ms): " + json.dumps(
        {k: round(v, 3) for k, v in sorted(prof["classes_ms"].items(),
                                           key=lambda kv: -kv[1])}))
    log("  top kernels: " + "; ".join(
        "%s %.2f ms x%d" % (k["name"][:70], k["ms"], k["calls"])
        for k in prof["top_kernels"]))
    return {"step_ms": steps_ms, "step_ms_p50": p50,
            "img_per_s": batch / (p50 / 1e3), "model_flops_per_step": flops,
            "model_flops_share_of_peak": share, "peak_memory_bytes": mem,
            "profile": prof}


def released(dev):
    """Drop what nothing references any more (cycles included) and hand
    the cached blocks back -> bytes still allocated on the card."""
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def resnet_train_path(dev, card, report):
    """Phase 13: ResNet-50 trained through Module.fit as bench.py's fit
    leg runs it, bf16 at batch 128 at tier auto (the main path) and off,
    then f32 at batch 32; the checks, the numbers and card vs CPU."""
    P = RESNET_TRAIN
    sym = resnet50()
    t0 = time.perf_counter()
    p0, aux0 = resnet_init(sym, dev)
    log("ResNet-50 v1 (224x224, 1000 classes): %.1f M f32 parameters, "
        "Xavier(in, 2) from seed 0 in %.1fs"
        % (sum(v.numel() for v in p0.values()) / 1e6,
           time.perf_counter() - t0))
    report["resnet_train"] = {"allocated_before_bytes": released(dev)}
    log("allocated on the card before the leg: %.2f GB"
        % (report["resnet_train"]["allocated_before_bytes"] / 1e9))
    X, Y = image_batch(P["bf16_batch"])
    steps = P["bf16_steps"]
    # -- tier auto, bf16: the main path, counts zeroed just before
    torch.cuda.reset_peak_memory_stats(dev)
    tier.reset_stats()
    bn_act.reset_launches()
    mod, loss_auto, stamps = resnet_fit(sym, X, Y, dev, steps, p0, aux0,
                                        mp=True)
    torch.cuda.synchronize()
    launches = dict(bn_act.launches_by_kernel)
    stats = tier.stats()
    mem = torch.cuda.max_memory_allocated(dev)
    log("ResNet-50 train path, bf16 batch %d, tier auto: %d steps, losses "
        "%s, launches %s, tier %s" % (P["bf16_batch"], steps,
                                      ["%.4f" % x for x in loss_auto],
                                      launches, json.dumps(stats["dispatch"])))
    if launches != {"bn_act": 33 * steps, "bn_act_res": 16 * steps} \
            or stats["fallback"]:
        raise RuntimeError("expected 49 B1 launches per training forward "
                           "over %d steps and no fallback, got %s, %s"
                           % (steps, launches, stats["fallback"]))
    n_aux = check_moving_stats(mod, aux0)
    if not falling(loss_auto):
        raise RuntimeError("losses not finite or not falling over the "
                           "repeated batch: %s" % loss_auto)
    step_ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    prof = resnet_step_profile(mod)
    bf16 = log_step("ResNet-50 bf16 train step, batch %d, tier auto"
                    % P["bf16_batch"], step_ms, P["bf16_batch"],
                    ("989 TFLOP/s bf16", BF16_FLOPS), prof, mem, card)
    del mod
    bf16["allocated_after_bytes"] = released(dev)
    log("  allocated on the card once the module is dropped: %.2f GB"
        % (bf16["allocated_after_bytes"] / 1e9))
    # -- tier off, bf16, from the same weights
    torch.cuda.reset_peak_memory_stats(dev)
    tier.reset_stats()
    bn_act.reset_launches()
    with mt.config.override(kernel_tier="off"):
        mod_off, loss_off, st_off = resnet_fit(sym, X, Y, dev, steps, p0,
                                               aux0, mp=True)
    torch.cuda.synchronize()
    mem_off = torch.cuda.max_memory_allocated(dev)
    off_stats = tier.stats()
    log("ResNet-50 train path, bf16, tier off: losses %s, launches %d"
        % (["%.4f" % x for x in loss_off], bn_act.launches))
    if bn_act.launches or off_stats["dispatch"]:
        raise RuntimeError("tier off launched B1: %d, %s"
                           % (bn_act.launches, off_stats["dispatch"]))
    check_moving_stats(mod_off, aux0)
    off_ms = [(b - a) * 1e3 for a, b in zip(st_off[1:], st_off[2:])]
    with mt.config.override(kernel_tier="off"):
        bf16_off = log_step("ResNet-50 bf16 train step, batch %d, tier off"
                            % P["bf16_batch"], off_ms, P["bf16_batch"],
                            ("989 TFLOP/s bf16", BF16_FLOPS),
                            resnet_step_profile(mod_off), mem_off, card)
    del mod_off
    released(dev)
    # -- the control: tier off again, the images moved by half a bf16 ulp
    # (another rounding of the same batch), for how far bf16 training
    # parts from itself over these steps
    with mt.config.override(kernel_tier="off"):
        mod_ctl, loss_ctl, _s = resnet_fit(sym, perturbed(X, 2 ** -9), Y,
                                           dev, steps, p0, aux0, mp=True)
    del mod_ctl
    released(dev)
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(loss_auto, loss_off)]
    ctl_rel = [abs(a - b) / abs(b) for a, b in zip(loss_ctl, loss_off)]
    # -- first-step gradients: the tiers, and bf16 against f32
    g_auto = resnet_grads(sym, p0, aux0, X, Y, dev, "auto", True)[1]
    g_off = resnet_grads(sym, p0, aux0, X, Y, dev, "off", True)[1]
    e_tier = rel_l2(g_auto, g_off)
    del g_auto
    released(dev)
    g_f32 = resnet_grads(sym, p0, aux0, X, Y, dev, "off", False)[1]
    e_bf16 = rel_l2(g_off, g_f32)
    del g_off, g_f32
    released(dev)
    med_tier = float(np.median(list(e_tier.values())))
    med_bf16 = float(np.median(list(e_bf16.values())))
    log("tiers, bf16: losses within %.3g relative at step 1, %.3g at worst "
        "(tier off against itself on images moved by half a bf16 ulp: "
        "%.3g at worst; losses %s); first-step gradients, relative L2 auto "
        "vs off: head %s (bf16 vs f32 at tier off: %s), median over all "
        "tensors %.4g (bf16 vs f32 %.4g)"
        % (loss_rel[0], max(loss_rel), max(ctl_rel),
           ["%.4f" % x for x in loss_ctl],
           json.dumps({k: round(e_tier[k], 5) for k in HEAD}),
           json.dumps({k: round(e_bf16[k], 5) for k in HEAD}), med_tier,
           med_bf16))
    # step 1 is one forward from the same weights; after it the bf16
    # trajectories part as bf16 training parts from itself (the control),
    # and they are held to the JAX package's own bf16-vs-f32 bound
    if loss_rel[0] > 5e-3 or max(loss_rel) > 5e-2 \
            or not falling(loss_off):
        raise RuntimeError("bf16 losses disagree across tiers: %s "
                           "(control %s)" % (loss_rel, ctl_rel))
    # both tiers round in bf16 where bf16-vs-f32 rounds on one side only:
    # two independent roundings part by about sqrt(2) times one
    if any(e_tier[k] > 2 * e_bf16[k] for k in HEAD):
        raise RuntimeError("the head's first-step gradients across tiers "
                           "are further apart than twice bf16 from f32: "
                           "%s, %s"
                           % ({k: e_tier[k] for k in HEAD},
                              {k: e_bf16[k] for k in HEAD}))
    # -- f32 at batch 32, tier auto
    X32, Y32 = image_batch(P["f32_batch"])
    torch.cuda.reset_peak_memory_stats(dev)
    tier.reset_stats()
    bn_act.reset_launches()
    mod32, loss32, st32 = resnet_fit(sym, X32, Y32, dev, P["f32_steps"], p0,
                                     aux0, mp=False)
    torch.cuda.synchronize()
    launches32 = dict(bn_act.launches_by_kernel)
    mem32 = torch.cuda.max_memory_allocated(dev)
    n32 = P["f32_steps"]
    log("ResNet-50 train path, f32 batch %d, tier auto: losses %s, "
        "launches %s" % (P["f32_batch"], ["%.4f" % x for x in loss32],
                         launches32))
    if launches32 != {"bn_act": 33 * n32, "bn_act_res": 16 * n32} \
            or tier.stats()["fallback"]:
        raise RuntimeError("f32: expected 49 B1 launches per forward, got "
                           "%s" % launches32)
    check_moving_stats(mod32, aux0)
    if not falling(loss32):
        raise RuntimeError("f32 losses not finite or not falling: %s"
                           % loss32)
    prof32 = resnet_step_profile(mod32)
    f32 = log_step("ResNet-50 f32 train step, batch %d, tier auto"
                   % P["f32_batch"], [(b - a) * 1e3 for a, b in
                                      zip(st32[1:], st32[2:])],
                   P["f32_batch"], ("67 TFLOP/s f32", F32_FLOPS), prof32,
                   mem32, card)
    del mod32
    released(dev)
    report["resnet_train"].update(
        launches_bf16=launches, launches_f32=launches32, tier_stats=stats,
        losses_bf16_auto=loss_auto, losses_bf16_off=loss_off,
        losses_f32=loss32, loss_rel_tiers=loss_rel,
        losses_bf16_control=loss_ctl, loss_rel_control=ctl_rel,
        grad_rel_l2_tiers=e_tier, grad_rel_l2_bf16_vs_f32=e_bf16,
        moving_stats=n_aux, bf16=bf16, f32=f32, bf16_off=bf16_off)
    resnet_card_vs_cpu(sym, p0, aux0, dev, report)
    return launches


# ------------------------------------------ Gluon image training (phase 14)
GLUON_IMG = dict(batch=32, steps=10, repeat_steps=6, workers_batches=2,
                 cut_batch=2, cut_size=32, cut_classes=10)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RANDOM_ULP = 4          # normal/exponential draws, card vs CPU (f32 ulp)
B1_OP_BATCHES = (("float32", 32), ("bfloat16", 128))


def reset_all_counts():
    from mxnet_tpu_torch.kernels import int8_dequant as dq
    reset_train_counts()
    bn_act.reset_launches()
    dq.reset_launches()


def all_counts():
    """Every kernel's launch count."""
    from mxnet_tpu_torch.kernels import int8_dequant as dq
    counts = dict(train_counts())
    counts.update(bn_act.launches_by_kernel)
    counts["int8_dequant"] = dq.launches
    return counts


def f32_ulps(a, b):
    """Distance of two f32 arrays in units in the last place."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def key_chain_phase(dev, report):
    """After ``random.seed(0)`` the same draws on the card and on the
    CPU: uniform, randint, Dropout masks (eager and in a hybridized
    block), shuffles and multinomial bitwise; normal and exponential
    within RANDOM_ULP f32 ulp (the card's log1p and sqrt)."""
    def draws(ctx):
        mt.random.seed(0)
        x = mt.nd.array(np.linspace(1, 3, 64 * 64).reshape(64, 64), ctx=ctx)
        drop = mt.gluon.nn.HybridSequential()
        drop.add(mt.gluon.nn.Dropout(0.5), mt.gluon.nn.Dropout(0.25))
        drop.hybridize()
        xg = x.copy()
        xg.attach_grad()
        with mt.autograd.record():
            hyb = drop(xg)
        probs = mt.nd.array(np.random.RandomState(3).dirichlet(
            np.ones(50), 40), ctx=ctx)
        out = {
            "uniform": mt.nd.random.uniform(-1, 2, shape=(200000,), ctx=ctx),
            "randint": mt.nd.random.randint(0, 1000, shape=(200000,),
                                            ctx=ctx),
            "dropout": mt.nd.Dropout(x, p=0.5, mode="always"),
            "dropout_hybridized": hyb,
            "shuffle": mt.nd.random.shuffle(mt.nd.array(
                np.arange(20000).reshape(4000, 5), ctx=ctx)),
            "multinomial": mt.nd.random.multinomial(probs, shape=(8,)),
            "normal": mt.nd.random.normal(shape=(200000,), ctx=ctx),
            "exponential": mt.nd.random.exponential(shape=(200000,),
                                                    ctx=ctx)}
        out = {k: v.asnumpy() for k, v in out.items()}
        out["state"] = np.asarray(mt.random.get_state()[0])
        return out
    card, cpu = draws(mt.gpu(0)), draws(mt.cpu())
    ulps = {}
    for k in card:
        if k in ("normal", "exponential"):
            ulps[k] = int(f32_ulps(card[k], cpu[k]).max())
            if ulps[k] > RANDOM_ULP:
                raise RuntimeError("random %s: card and CPU %d ulp apart (at "
                                   "most %d)" % (k, ulps[k], RANDOM_ULP))
        elif not np.array_equal(card[k], cpu[k]):
            raise RuntimeError("random %s: the card's draws are not the "
                               "CPU's" % k)
    log("key chain after seed(0), card against CPU: uniform, randint, "
        "Dropout masks (eager and hybridized), shuffle, multinomial and the "
        "chain state bitwise; normal and exponential within %s f32 ulp"
        % json.dumps(ulps))
    report["gluon_image"]["key_chain_ulps"] = ulps


def image_set(n, seed=0):
    """uint8 HWC 224x224 images and labels in [0, 1000) from numpy
    RandomState(seed)."""
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (n, 224, 224, 3)).astype(np.uint8)
    labels = rng.randint(0, 1000, (n,)).astype(np.float32)
    return images, labels


def image_dataset(images, labels, flip=True):
    """ArrayDataset on the host, its images through RandomFlipLeftRight
    (when ``flip``), ToTensor and Normalize."""
    T = mt.gluon.data.vision.transforms
    chain = ([T.RandomFlipLeftRight()] if flip else []) \
        + [T.ToTensor(), T.Normalize(IMAGENET_MEAN, IMAGENET_STD)]
    ds = mt.gluon.data.ArrayDataset(
        mt.nd.array(images, ctx=mt.cpu(), dtype="uint8"), labels)
    return ds.transform_first(T.Compose(chain))


def gluon_snapshot(net):
    return {k: p.data()._data.detach().clone()
            for k, p in gluon_params(net).items()}


def zoo_train(net, batches, ctx, trainer, loss_fn):
    """The Gluon loop over ``batches`` (an iterator of (x, y)): fetch,
    place on ``ctx``, ``record`` -> loss -> ``backward`` -> ``step``.
    Returns per step the loss (read on the card), the host time of the
    fetch and of the step, and the launches the step made; every
    parameter must stay f32."""
    losses, fetch_ms, step_ms, census = [], [], [], []
    params = list(net.collect_params().values())
    while True:
        t0 = time.perf_counter()
        try:
            x, y = next(batches)
        except StopIteration:
            break
        x, y = x.as_in_context(ctx), y.as_in_context(ctx)
        t1 = time.perf_counter()
        before = all_counts()
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])
        losses.append(float(loss.mean().asscalar()))     # syncs the card
        t2 = time.perf_counter()
        after = all_counts()
        census.append({k: after[k] - before[k] for k in after
                       if after[k] != before[k]})
        fetch_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t1) * 1e3)
        bad = [p.name for p in params if p.data().dtype != torch.float32]
        if bad:
            raise RuntimeError("gluon image: parameters left f32: %s"
                               % bad[:3])
    return losses, fetch_ms, step_ms, census


def zoo_step_profile(net, x, y, trainer, loss_fn):
    """One hybridized step: forward (with the loss), backward and update
    with CUDA events (median of 3), then torch.profiler over one more:
    busy share, device time by kind of kernel and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def step(ev=None):
        if ev:
            ev[0].record()
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        if ev:
            ev[1].record()
        loss.backward()
        if ev:
            ev[2].record()
        trainer.step(x.shape[0])
        if ev:
            ev[3].record()
    split = step_split(step)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(k[1] for k in kernels)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    classes = {}
    for k in kernels:
        c = kernel_class(k[0])
        classes[c] = classes.get(c, 0.0) + k[1] / 1e3
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return {**split, "profiled_wall_ms": wall_us / 1e3,
            "device_ms": busy / 1e3, "device_busy_share": busy / wall_us,
            "kernel_launches": sum(k[2] for k in kernels),
            "classes_ms": classes,
            "top_kernels": [{"name": k[0][:100], "ms": k[1] / 1e3,
                             "calls": k[2]} for k in top]}


def params_round_trip(net, x, dev, report):
    """``save_parameters`` then ``resnet50_v1().load_parameters(path,
    ctx=gpu(0))``: the reloaded net's inference outputs bitwise the
    original's, and the file's bytes those of a save of the same values
    from CPU tensors (the format writes kCPU, 0 from any device)."""
    out_dir = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "gluon_resnet50_v1.params")
    host_path = os.path.join(out_dir, "gluon_resnet50_v1.host.params")
    t0 = time.perf_counter()
    net.save_parameters(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = mt.gluon.model_zoo.vision.resnet50_v1(classes=1000)
    again.load_parameters(path, ctx=mt.gpu(0))
    load_s = time.perf_counter() - t0
    again.hybridize()
    with mt.autograd.predict_mode():
        a = net(x).data
        b = again(x).data
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise RuntimeError("gluon: the reloaded net's outputs are not the "
                           "saved net's (max abs diff %g)"
                           % float((a - b).abs().max()))
    mt.nd.save(host_path, {k: mt.nd.NDArray(p.data()._data.detach().cpu())
                           for k, p in
                           net._collect_params_with_prefix().items()})
    with open(path, "rb") as f1, open(host_path, "rb") as f2:
        same = f1.read() == f2.read()
    size = os.path.getsize(path)
    log("gluon .params round trip: %.1f MB saved in %.2fs from the card, "
        "loaded onto a fresh resnet50_v1 on the card in %.2fs; inference "
        "outputs bitwise equal; file bytes equal to a save from CPU "
        "tensors: %s" % (size / 1e6, save_s, load_s, same))
    if not same:
        raise RuntimeError("gluon: the .params bytes saved from the card "
                           "differ from a save of the same values on the "
                           "host")
    report["gluon_image"]["params_file"] = {
        "bytes": size, "save_s": save_s, "load_s": load_s}
    del again
    for p in (path, host_path):
        os.remove(p)


class ReluTape:
    """Stands in for the ``Activation`` op: records each relu input
    (``record``), or applies recorded ReLU decisions while recording the
    inputs it sees (``replay``)."""

    def __init__(self):
        self.op = mt.ops.registry.get("Activation")
        self.fn = self.op.fn
        self.seen, self.masks = [], []

    def __enter__(self):
        self.op.fn = self._call
        return self

    def __exit__(self, *a):
        self.op.fn = self.fn

    def _call(self, data, *, act_type="relu"):
        if act_type != "relu":
            return self.fn(data, act_type=act_type)
        self.seen.append(data.detach().float().cpu())
        if not self.masks:
            return self.fn(data, act_type=act_type)
        m = self.masks.pop(0)
        return data * m.to(data.device, data.dtype)


def zoo_cut_check(report):
    """``resnet18_v1(thumbnail=True, classes=10)`` at 32x32, batch 2, on
    the card against the CPU from the same weights: two SGD-momentum
    steps (lr 1e-4), the CPU differentiating through the card's ReLU
    decisions; phase 9's limits: step-1 gradients within 1e-3 of each
    tensor's largest magnitude, losses within 1e-5 relative, parameters
    within 1e-4, at most 4 ReLU inputs of opposite sign, each within
    1e-4 of its tensor's largest magnitude from 0."""
    P = GLUON_IMG
    rng = np.random.RandomState(5)
    X = rng.randn(2 * P["cut_batch"], 3, P["cut_size"], P["cut_size"]) \
        .astype(np.float32)
    Y = rng.randint(0, P["cut_classes"], 2 * P["cut_batch"]) \
        .astype(np.float32)
    sgd = {"learning_rate": 1e-4, "momentum": 0.9, "wd": 0.01}
    p0, runs, card_masks = None, {}, []
    for name, ctx in (("card", mt.gpu(0)), ("cpu", mt.cpu())):
        net = mt.gluon.model_zoo.vision.resnet18_v1(
            thumbnail=True, classes=P["cut_classes"])
        net.initialize(mt.init.Xavier(factor_type="in", magnitude=2,
                                      seed=0), ctx=ctx)
        with mt.autograd.predict_mode():
            net(mt.nd.array(X[:1], ctx=ctx))
        if p0 is None:
            p0 = {k: v.cpu() for k, v in gluon_snapshot(net).items()}
        gluon_load(net, p0)
        net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(sgd))
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        losses, grads, seen = [], None, []
        for s in range(2):
            b = slice(s * P["cut_batch"], (s + 1) * P["cut_batch"])
            x, y = mt.nd.array(X[b], ctx=ctx), mt.nd.array(Y[b], ctx=ctx)
            with ReluTape() as tape:
                if name == "cpu":
                    tape.masks = [(m > 0).float() for m in card_masks[s]]
                with mt.autograd.record():
                    loss = loss_fn(net(x), y)
            if name == "card":
                card_masks.append(tape.seen)
            seen.append(tape.seen)
            loss.backward()
            if s == 0:
                grads = {k: p.grad()._data.detach().cpu().clone()
                         for k, p in gluon_params(net).items()
                         if p.grad_req != "null"}
            trainer.step(P["cut_batch"])
            losses.append(float(loss.mean().asscalar()))
        runs[name] = (losses, grads, {k: v.cpu() for k, v in
                                      gluon_snapshot(net).items()}, seen)
        del net, trainer
    (lg, gg, pg, sg), (lc, gc_, pc, sc_) = runs["card"], runs["cpu"]
    flips, flip_far = relu_flips({
        "step%d/relu%d" % (s, i): (a, b)
        for s in range(2) for i, (a, b) in enumerate(zip(sc_[s], sg[s]))})
    flips = {k: v for k, v in flips.items() if v}
    grad_err = {k: float((gg[k] - v).abs().max()
                         / v.abs().max().clamp_min(1e-30))
                for k, v in gc_.items()}
    param_err = {k: float((pg[k] - v).abs().max()) for k, v in pc.items()}
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lg, lc))
    wg = max(grad_err, key=grad_err.get)
    wp = max(param_err, key=param_err.get)
    log("gluon resnet18_v1 (thumbnail, 10 classes, 32x32, batch 2), card "
        "vs CPU through the card's ReLU decisions: step-1 gradients within "
        "%.3g of the tensor's largest magnitude (worst %s); ReLU inputs of "
        "opposite sign %s, the farthest %.3g of its tensor's largest "
        "magnitude from 0; after 2 SGD-momentum steps at lr 1e-4 losses "
        "within %.3g relative, parameters within %.3g (worst %s)"
        % (grad_err[wg], wg, json.dumps(flips), flip_far, loss_err,
           param_err[wp], wp))
    report["gluon_image"].update(
        cut_grad_err_worst=grad_err[wg], cut_relu_flips=flips,
        cut_relu_flip_far=flip_far, cut_loss_err=loss_err,
        cut_param_err_worst=param_err[wp])
    if grad_err[wg] > 1e-3 or param_err[wp] > 1e-4 or loss_err > 1e-5:
        raise RuntimeError("gluon resnet18: card and CPU disagree at cut "
                           "size: gradients %g (%s), losses %g, parameters "
                           "%g (%s)" % (grad_err[wg], wg, loss_err,
                                        param_err[wp], wp))
    check_relu_flips(flips, flip_far, "gluon resnet18 cut size")


def workers_check(images, labels, dev, report):
    """The DataLoader with ``num_workers=2`` while the card is in use:
    forked workers batchify to numpy, the main process places each batch
    on the card; the batches equal ``num_workers=0``'s bitwise."""
    ds = image_dataset(images, labels, flip=False)
    got = {}
    for workers in (0, 2):
        loader = mt.gluon.data.DataLoader(ds, batch_size=GLUON_IMG["batch"],
                                          num_workers=workers)
        t0 = time.perf_counter()
        done = []

        def run(loader=loader):
            try:
                done.append([[a.as_in_context(mt.gpu(0)) for a in b]
                             for b in loader])
            except BaseException as e:     # raised below, in this thread
                done.append(e)
        # a worker that dies leaves a Pool waiting for ever: bound the wait
        th = threading.Thread(target=run, daemon=True)
        th.start()
        th.join(timeout=300)
        if not done:
            raise RuntimeError("gluon DataLoader with %d workers gave no "
                               "batches within 300 s" % workers)
        if isinstance(done[0], BaseException):
            raise done[0]
        batches = done[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(batches)
        got[workers] = (batches, ms)
    (b0, ms0), (b2, ms2) = got[0], got[2]
    same = len(b0) == len(b2) and all(
        torch.equal(a.data, b.data) and a.data.device.type == "cuda"
        for x0, x2 in zip(b0, b2) for a, b in zip(x0, x2))
    log("gluon DataLoader, num_workers=2 beside a card in use: %d batches "
        "of %d on the card, bitwise num_workers=0's: %s; host time a batch "
        "%.1f ms (2 workers, pool start included) vs %.1f ms (in process)"
        % (len(b2), GLUON_IMG["batch"], same, ms2, ms0))
    if not same:
        raise RuntimeError("gluon DataLoader: the workers' batches are not "
                           "the main process's")
    report["gluon_image"]["workers"] = {"batch_ms_2": ms2, "batch_ms_0": ms0}


def b1_op_case(form, chw, dtype, batch, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    C = chw[0]
    shape = (batch,) + tuple(chw)
    return dict(
        x=torch.randn(shape, generator=g, device=dev).to(dtype),
        r=(torch.randn(shape, generator=g, device=dev).to(dtype)
           if form == "bn_act_res" else None),
        gamma=torch.rand(C, generator=g, device=dev) + 0.5,
        beta=torch.randn(C, generator=g, device=dev),
        mm=0.3 * torch.randn(C, generator=g, device=dev),
        mv=torch.rand(C, generator=g, device=dev) + 0.5,
        cot=torch.randn(shape, generator=g, device=dev).to(dtype))


def b1_close(got, want, dtype_name, what, rel_to_max=False):
    """Phase 3's tolerance: f32 within atol/rtol 1e-5; bf16 within one
    bf16 ulp plus 1e-5. Gradients (``rel_to_max``) relative to the
    tensor's largest magnitude."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    scale = want.abs().max().clamp_min(1e-30) if rel_to_max \
        else want.abs()
    if dtype_name == "float32":
        bad = diff > 1e-5 + 1e-5 * scale
    else:
        bad = diff > torch.maximum(got.abs(), want.abs()) * 2 ** -7 \
            + 1e-5 * (scale if rel_to_max else 1.0)
    if bool(bad.any()):
        raise RuntimeError("_contrib_FusedBNAct %s: max abs err %g"
                           % (what, float(diff.max())))
    return float(diff.max())


def b1_op_plain(d, training):
    """The plain version: the op's coefficients and statistics
    (``bn_act._coefs``), the kernel's plain version on them, and the vjp
    of the unfused composition (``bn_act._reference``) the op's backward
    is defined by -> (out, moving mean, moving var, grads of x, gamma,
    beta[, r])."""
    leaves = [d["x"], d["gamma"], d["beta"]] \
        + ([d["r"]] if d["r"] is not None else [])
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    kw = dict(eps=1e-3, momentum=0.9, fix_gamma=False,
              use_global_stats=False, training=training)
    with torch.enable_grad():
        ref = bn_act._reference(leaves[0], leaves[1], leaves[2], d["mm"],
                                d["mv"], leaves[3] if len(leaves) > 3
                                else None, "relu", **kw)
        grads = torch.autograd.grad(ref, leaves, d["cot"])
    sc, sh, _m, _v, new_mean, new_var = bn_act._coefs(
        d["x"], d["gamma"], d["beta"], d["mm"], d["mv"], **kw)
    out = bn_act._plain_epilogue(d["x"], sc, sh, d["r"], "relu")
    return [out, new_mean, new_var] + list(grads)


def b1_op_eager(d, training):
    """``nd.contrib.FusedBNAct`` (recorded when ``training``) -> the same
    list as ``b1_op_plain``, the moving statistics as written back."""
    nd = mt.nd
    x, g, b = (nd.NDArray(d[k].clone()) for k in ("x", "gamma", "beta"))
    mm, mv = nd.NDArray(d["mm"].clone()), nd.NDArray(d["mv"].clone())
    ins = [x, g, b, mm, mv] + ([nd.NDArray(d["r"].clone())]
                               if d["r"] is not None else [])
    diff = [x, g, b] + ins[5:]
    for v in diff:
        v.attach_grad()
    with mt.autograd.record(train_mode=training):
        out = nd.contrib.FusedBNAct(*ins, act="relu", fix_gamma=False,
                                    eps=1e-3, momentum=0.9)
        (out * nd.NDArray(d["cot"])).sum().backward()
    return [t.detach() for t in [out.data, mm.data, mv.data]
            + [v.grad.data for v in diff]]


class FusedBNActBlock(mt.gluon.HybridBlock):
    """A HybridBlock around ``F.contrib.FusedBNAct`` with BatchNorm's four
    parameters, the moving statistics as aux."""

    def __init__(self, channels, **kw):
        super().__init__(**kw)
        with self.name_scope():
            self.gamma = self.params.get("gamma", shape=(channels,))
            self.beta = self.params.get("beta", shape=(channels,))
            self.running_mean = self.params.get(
                "running_mean", shape=(channels,), grad_req="null")
            self.running_var = self.params.get(
                "running_var", shape=(channels,), grad_req="null")

    def hybrid_forward(self, F, x, *res, gamma, beta, running_mean,
                       running_var):
        return F.contrib.FusedBNAct(x, gamma, beta, running_mean,
                                    running_var, *res, act="relu",
                                    fix_gamma=False, eps=1e-3, momentum=0.9)


def b1_op_block(d, training):
    """The same through ``F.contrib.FusedBNAct`` in a hybridized block."""
    blk = FusedBNActBlock(d["x"].shape[1], prefix="fusedbnact_")
    blk.initialize(ctx=mt.gpu(0))
    for name, key in (("gamma", "gamma"), ("beta", "beta"),
                      ("running_mean", "mm"), ("running_var", "mv")):
        getattr(blk, name).set_data(mt.nd.NDArray(d[key].clone()))
    blk.hybridize()
    ins = [mt.nd.NDArray(d["x"].clone())] + (
        [mt.nd.NDArray(d["r"].clone())] if d["r"] is not None else [])
    for v in ins:
        v.attach_grad()
    with mt.autograd.record(train_mode=training):
        out = blk(*ins)
        (out * mt.nd.NDArray(d["cot"])).sum().backward()
    grads = [ins[0].grad.data, blk.gamma.grad().data, blk.beta.grad().data]
    grads += [v.grad.data for v in ins[1:]]
    return [t.detach() for t in [out.data, blk.running_mean.data().data,
                                 blk.running_var.data().data] + grads]


def b1_op_phase(sites, dev, report, b1_train_totals, serve_totals):
    """B1's op surface, ``_contrib_FusedBNAct``: at the 9 site classes of
    ResNet-50, f32 at batch 32 and bf16 at batch 128, with the residual
    where the class has it, in training (recorded) and in inference,
    eagerly (``nd.contrib``) and in a hybridized block (``F.contrib``),
    each call launching B1 exactly once, no fallback; outputs and moving
    statistics to phase 3's tolerances against the plain version, the
    gradients against its vjp. Then the eager op's time per class in
    inference (the coefficients and the kernel), summed over the 49
    sites, beside phase 3's and phase 12's kernel totals."""
    classes = sorted(set(sites))
    max_err = {"bn_act": 0.0, "bn_act_res": 0.0}
    tier.reset_stats()
    bn_act.reset_launches()
    calls = {"bn_act": 0, "bn_act_res": 0}
    names = ("out", "moving_mean", "moving_var", "dx", "dgamma", "dbeta",
             "dr")
    for dtype_name, batch in B1_OP_BATCHES:
        dtype = getattr(torch, dtype_name)
        for i, (form, chw) in enumerate(classes):
            d = b1_op_case(form, chw, dtype, batch, dev, 300 + i)
            for training in (True, False):
                want = b1_op_plain(d, training)
                for how, fn in (("eager", b1_op_eager),
                                ("F.contrib", b1_op_block)):
                    before = bn_act.launches
                    got = fn(d, training)
                    torch.cuda.synchronize()
                    calls[form] += 1
                    if bn_act.launches - before != 1:
                        raise RuntimeError(
                            "_contrib_FusedBNAct (%s) launched B1 %d times "
                            "in one call" % (how, bn_act.launches - before))
                    for n, g_, w in zip(names, got, want):
                        what = "%s %s %s %s training=%s %s" % (
                            how, form, (batch,) + chw, n, training,
                            dtype_name)
                        e = b1_close(g_, w, str(w.dtype).replace(
                            "torch.", ""), what,
                            rel_to_max=n.startswith("d"))
                        if n == "out":
                            max_err[form] = max(max_err[form], e)
                del got
            del d, want
    torch.cuda.synchronize()
    launches = dict(bn_act.launches_by_kernel)
    stats = tier.stats()
    if launches != calls or stats["fallback"]:
        raise RuntimeError("_contrib_FusedBNAct: launches %s for %s calls, "
                           "fallback %s" % (launches, calls,
                                            stats["fallback"]))
    # times: the eager op in inference, per class, summed over the sites
    op_totals = {}
    for dtype_name, batch in B1_OP_BATCHES:
        dtype = getattr(torch, dtype_name)
        tot = 0.0
        for i, (form, chw) in enumerate(classes):
            d = b1_op_case(form, chw, dtype, batch, dev, 300 + i)
            ins = [mt.nd.NDArray(d[k]) for k in ("x", "gamma", "beta",
                                                  "mm", "mv")]
            if d["r"] is not None:
                ins.append(mt.nd.NDArray(d["r"]))
            with mt.autograd.predict_mode():
                ms = time_ms(lambda: mt.nd.contrib.FusedBNAct(
                    *ins, act="relu", fix_gamma=False), dev)
            tot += ms * sum(1 for s in sites if s == (form, chw))
            del d, ins
        op_totals[dtype_name] = tot
    kern32 = serve_totals["float32/all"]["kernel_ms"]
    kern16 = b1_train_totals["all"]["kernel_ms"]
    log("_contrib_FusedBNAct: %d calls (%s), each one B1 launch, no "
        "fallback; outputs, moving statistics and gradients within phase "
        "3's tolerances of the plain version (max abs err of the outputs "
        "%s); the eager op in inference summed over the 49 sites: f32 "
        "batch 32 %.4f ms (phase 3's kernel alone %.4f ms), bf16 batch 128 "
        "%.4f ms (phase 12's kernel alone %.4f ms)"
        % (sum(calls.values()), json.dumps(calls), json.dumps(max_err),
           op_totals["float32"], kern32, op_totals["bfloat16"], kern16))
    report["gluon_image"]["b1_op"] = {
        "calls": calls, "launches": launches, "max_abs_err": max_err,
        "op_ms_49_sites": op_totals, "kernel_ms_49_sites": {
            "float32": kern32, "bfloat16": kern16}}
    return launches, max_err, op_totals


def gluon_image_path(dev, card, report, sites, b1_train_totals,
                     serve_totals):
    """Phase 14: ResNet-50 v1 from gluon.model_zoo trained through Gluon
    at full width (the main path), the key chain on the card, the
    DataLoader's workers, the .params round trip, card against CPU at
    cut size, and B1's op surface ``_contrib_FusedBNAct``."""
    P = GLUON_IMG
    ctx = mt.gpu(0)
    report["gluon_image"] = {}
    key_chain_phase(dev, report)
    released(dev)
    n_img = P["batch"] * P["steps"]
    t0 = time.perf_counter()
    images, labels = image_set(n_img)
    mt.random.seed(0)
    net = mt.gluon.model_zoo.vision.resnet50_v1(classes=1000)
    net.initialize(mt.init.Xavier(factor_type="in", magnitude=2, seed=0),
                   ctx=ctx)
    with mt.autograd.predict_mode():
        net(mt.nd.zeros((1, 3, 224, 224), ctx=ctx))
    p0 = gluon_snapshot(net)
    net.hybridize()
    log("gluon model_zoo resnet50_v1 (224x224, 1000 classes): %.1f M f32 "
        "parameters in %d tensors, Xavier(in, 2) from seed 0; %d uint8 "
        "images in %.1fs" % (sum(v.numel() for v in p0.values()) / 1e6,
                             len(p0), n_img, time.perf_counter() - t0))
    ds = image_dataset(images, labels)
    loader = mt.gluon.data.DataLoader(ds, batch_size=P["batch"],
                                      shuffle=True, last_batch="discard")
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9,
                                "wd": 1e-4})
    # -- the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_counts()
    losses, fetch_ms, step_ms, census = zoo_train(net, iter(loader), ctx,
                                                  trainer, loss_fn)
    torch.cuda.synchronize()
    counts = all_counts()
    stats = tier.stats()
    mem = torch.cuda.max_memory_allocated(dev)
    log("gluon image path, resnet50_v1 hybridized, f32 batch %d, %d steps: "
        "losses %s; launches %s, tier %s"
        % (P["batch"], len(losses), ["%.4f" % v for v in losses],
           json.dumps(counts), json.dumps(stats["dispatch"])))
    if len(losses) != P["steps"] or any(census) or any(counts.values()) \
            or stats["dispatch"] or stats["fallback"]:
        raise RuntimeError("gluon image path: expected %d steps launching "
                           "no kernel (Gluon fuses no BatchNorm+ReLU), got "
                           "%d steps, census %s, tier %s"
                           % (P["steps"], len(losses), census[:2], stats))
    if not np.isfinite(losses).all():
        raise RuntimeError("gluon image path: losses not finite: %s"
                           % losses)
    x_last = None
    for x_last, y_last in loader:
        break
    x_last = x_last.as_in_context(ctx)
    y_last = y_last.as_in_context(ctx)
    # -- one batch repeated: the loss falls
    gluon_load(net, p0)
    trainer_rep = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05, "momentum": 0.9,
                                    "wd": 1e-4})
    rep = zoo_train(net, iter([(x_last, y_last)] * P["repeat_steps"]), ctx,
                    trainer_rep, loss_fn)[0]
    log("gluon image path, one batch %d times: losses %s"
        % (P["repeat_steps"], ["%.4f" % v for v in rep]))
    if not falling(rep):
        raise RuntimeError("gluon image path: the loss did not fall on a "
                           "repeated batch: %s" % rep)
    # -- the numbers
    prof = zoo_step_profile(net, x_last, y_last, trainer_rep, loss_fn)
    p50 = float(np.median(step_ms[1:]))
    loop = float(np.median([a + b for a, b in zip(fetch_ms[1:],
                                                  step_ms[1:])]))
    fetch = float(np.median(fetch_ms[1:]))
    flops = RESNET50_TRAIN_FLOPS_PER_IMG * P["batch"]
    share = flops / (p50 / 1e3) / F32_FLOPS
    fit_p50 = report["resnet_train"]["f32"]["step_ms_p50"]
    log("gluon resnet50_v1 train step, f32 batch %d: p50 %.2f ms over steps "
        "2-%d (%.1f images/s; %.3f TFLOP model FLOPs a step = %.1f%% of the "
        "67 TFLOP/s f32 peak); with the DataLoader's fetch %.2f ms a batch "
        "(host: flip, ToTensor, Normalize, stack, copy to the card) the loop "
        "runs %.2f ms a batch (%.1f images/s); Module.fit's f32 batch-%d "
        "step in this run (phase 13) %.2f ms; peak memory %.2f GB  [%s]"
        % (P["batch"], p50, len(step_ms), P["batch"] / (p50 / 1e3),
           flops / 1e12, 100 * share, fetch, loop,
           P["batch"] / (loop / 1e3), RESNET_TRAIN["f32_batch"], fit_p50,
           mem / 1e9, card))
    log("  one step: forward %.2f ms, backward %.2f ms, update %.2f ms (CUDA "
        "events), wall %.2f ms; profiled: %.2f ms wall, %.2f ms device (busy "
        "%.1f%%), %d kernel launches; device time by kind (ms) %s"
        % (prof["forward_ms"], prof["backward_ms"], prof["update_ms"],
           prof["wall_ms"], prof["profiled_wall_ms"], prof["device_ms"],
           100 * prof["device_busy_share"], prof["kernel_launches"],
           json.dumps({k: round(v, 3) for k, v in sorted(
               prof["classes_ms"].items(), key=lambda kv: -kv[1])})))
    log("  top kernels: " + "; ".join(
        "%s %.2f ms x%d" % (k["name"][:70], k["ms"], k["calls"])
        for k in prof["top_kernels"][:8]))
    report["gluon_image"].update(
        losses=losses, losses_repeated=rep, launches=counts, census=census,
        tier_stats=stats, perf={
            "step_ms": step_ms, "fetch_ms": fetch_ms, "step_ms_p50": p50,
            "img_per_s": P["batch"] / (p50 / 1e3), "loop_ms_p50": loop,
            "loop_img_per_s": P["batch"] / (loop / 1e3),
            "fetch_ms_p50": fetch, "model_flops_per_step": flops,
            "model_flops_share_of_f32_peak": share,
            "peak_memory_bytes": mem, "module_fit_f32_step_ms_p50": fit_p50,
            "profile": prof})
    params_round_trip(net, x_last, dev, report)
    del net, trainer, trainer_rep, x_last, y_last, loader
    released(dev)
    workers_check(images[:P["batch"] * P["workers_batches"]],
                  labels[:P["batch"] * P["workers_batches"]], dev, report)
    del images, ds
    zoo_cut_check(report)
    released(dev)
    return b1_op_phase(sites, dev, report, b1_train_totals, serve_totals)


# ------------------------------------------------------------------- main
# ------------------------------------------ grouped dispatch (phase 15)
GROUPED = dict(k=30, windows=3, auto_batches=32, auto_k=16, gpt_layers=2,
               gpt_k=4, drop_k=4, drop_batches=8, drop_batch=64)
# the graph kernels a census counts: B1 by its residual template flag,
# B2, B3 (the flash tile; B7 shares it and runs only at tier off), B5
CENSUS_KERNELS = (("bn_act_kernel", "bn_act"), ("take_rows_kernel",
                                                "take_rows"),
                  ("flash_attn_kernel", "flash_attn"),
                  ("scale_bias_act_kernel", "scale_bias_act"))
# the host's wait at each edge of a census's active profiler cycle
CENSUS_GAP_S = 0.5


def census_name(name):
    """The port's kernel a profiled device kernel name is, or None; B1's
    residual flag (its third template argument) read from the demangled
    ``<..., true, ...>`` or the mangled ``Lb1E`` form."""
    for sub, kname in CENSUS_KERNELS:
        if sub in name and "paged" not in name:
            if kname != "bn_act":
                return kname
            rest = name.split(sub, 1)[1]
            if rest.startswith("<"):
                flag = rest[1:].split(">", 1)[0].split(",")[2].strip()
                res = flag == "true"
            else:
                res = rest.split("Lb", 1)[1][:1] == "1"
            return "bn_act_res" if res else "bn_act"
    return None


def graph_census(fn):
    """torch.profiler over a call of ``fn`` (a replayed window): the
    port's kernels counted by their device names, the device time, the
    wall time and the busy share. The Python launch counters count where
    a wrapper launches, which under a graph is the capture only, so a
    replay's census comes from the device. ``fn`` runs twice, the first
    time in the profiler's warm-up cycle, whose records are dropped.

    The profiler splits its cycles on the host's clock, and a kernel's
    record carries the card's clock converted to the host's, which
    may drift over a long process: in full runs of this script the
    active cycle once lost the first kernel of the window's first replay
    and once held 30 B1 kernels more than the window launches. So the
    host waits ``CENSUS_GAP_S`` at each boundary, and the census
    counts only the kernels that ran between two marker kernels
    (``torch.cuda._sleep``'s ``spin_kernel``), each launched with the
    card idle just before and just after the profiled call: the order
    of records on one clock is exact whatever that clock's offset."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(CENSUS_GAP_S)
        prof.step()
        time.sleep(CENSUS_GAP_S)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(CENSUS_GAP_S)
    # the schedule's "ProfilerStep#" range is a device-side annotation
    # spanning the cycle, not a kernel
    device = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA
              and not e.name.startswith("ProfilerStep")]
    marks = sorted((e for e in device if "spin_kernel" in e.name),
                   key=lambda e: e.time_range.start)
    if len(marks) != 2:
        raise RuntimeError("census: %d marker kernels recorded, expected 2"
                           % len(marks))
    lo, hi = marks[0].time_range.end, marks[1].time_range.start
    inside = [e for e in device if "spin_kernel" not in e.name
              and lo <= e.time_range.start and e.time_range.end <= hi]
    outside = sum(1 for e in device if "spin_kernel" not in e.name
                  and census_name(e.name) is not None) \
        - sum(1 for e in inside if census_name(e.name) is not None)
    by_key = {}
    for e in inside:
        us, n = by_key.get(e.name, (0.0, 0))
        by_key[e.name] = (us + e.time_range.elapsed_us(), n + 1)
    kernels = [(k, us, n) for k, (us, n) in by_key.items()]
    busy = sum(k[1] for k in kernels) / 1e3
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    if outside:
        log("  census: %d records of the port's kernels lay outside the "
            "markers and are not counted" % outside)
    counts, kms, names = {}, {}, {}
    for key, us, n in kernels:
        c = census_name(key)
        if c is not None:
            counts[c] = counts.get(c, 0) + n
            kms[c] = kms.get(c, 0.0) + us / 1e3
            names[key[:90]] = n
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    return {"counts": counts, "kernel_ms": kms, "device_ms": busy,
            "wall_ms": wall_ms, "busy_share": busy / wall_ms,
            "names": names, "outside_markers": outside,
            "top_kernels": ["%s %.2f ms x%d" % (k[0][:70], k[1] / 1e3, k[2])
                            for k in top]}


def window_recorder(mod):
    """Wrap ``mod._fit_step_k`` so every window's stacked outputs are
    kept (the per-step losses and metric of a grouped run) -> the list
    they are appended to."""
    seen = []
    real = mod._fit_step_k

    def record(batches, **kw):
        outs = real(batches, **kw)
        seen.append([o.detach() for o in outs])
        return outs
    mod._fit_step_k = record
    return seen


def window_losses(windows, lab):
    """Per-step mean cross-entropy of stacked softmax outputs at ``lab``
    (read on the card)."""
    out = []
    for outs in windows:
        p = outs[0].float().gather(2, lab.view(1, -1, 1).expand(
            outs[0].shape[0], -1, 1)).clamp_min(1e-30)
        out.extend((-p.log().mean(dim=(1, 2))).tolist())
    return out


def grouped_module(sym, X, Y, dev, p0, aux0):
    """Phase 13's set-up for the grouped run: bound at the batch,
    ``p0``/``aux0``, SGD lr 0.05 momentum 0.9 ``multi_precision``,
    ``tpu_sync`` (bf16 compute over f32 masters)."""
    mod = mt.mod.Module(sym, context=dev)
    mod.bind([("data", X.shape)], [("softmax_label", Y.shape)])
    mod.init_params(arg_params=p0, aux_params=aux0)
    mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                       optimizer_params=dict(RESNET_SGD,
                                             multi_precision=True))
    return mod


def grouped_fit(mod, it, k, eval_metric=None):
    """``mod.fit`` over ``it`` (a bound, initialized module: the set-up
    is kept) with ``steps_per_dispatch=k``."""
    mod.fit(it, num_epoch=1, eval_metric=eval_metric, kvstore="tpu_sync",
            steps_per_dispatch=k)


def grouped_resnet(dev, card, report):
    """The main path of phase 15: ResNet-50 bf16 at batch 128 through
    ``Module.fit(steps_per_dispatch=30)``, 3 windows, each one captured
    CUDA graph of the step replayed; held against K = 1 from the same
    start; then a profiled window and fit's automatic K on defaults."""
    P, G = RESNET_TRAIN, GROUPED
    K, W = G["k"], G["windows"]
    sym = resnet50()
    p0, aux0 = resnet_init(sym, dev)
    X, Y = image_batch(P["bf16_batch"])
    released(dev)
    # -- the reference: K = 1 from the same start, K steps
    mod1, loss1, _st = resnet_fit(sym, X, Y, dev, K, p0, aux0, mp=True)
    del mod1
    released(dev)
    # -- the main path: counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    mod = grouped_module(sym, X, Y, dev, p0, aux0)
    fused = mod._fused
    windows = window_recorder(mod)
    lab = torch.from_numpy(Y).to(dev).long()
    tier.reset_stats()
    bn_act.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grouped_fit(mod, OneBatchIter(X, Y, K, dev), K)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    if fused.captures != 1 or fused.eager_steps != 2 \
            or fused.replays != K - 2:
        raise RuntimeError("window 1: %d captures, %d eager steps, %d "
                           "replays; expected 1, 2 (the warm-up), %d"
                           % (fused.captures, fused.eager_steps,
                              fused.replays, K - 2))
    # windows 2..W: replays only, no host sync inside (the one wait
    # allowed is the DepthController's event, which this mode lets by);
    # the batch goes to the card before
    it = OneBatchIter(X, Y, (W - 1) * K, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        grouped_fit(mod, it, K)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(bn_act.launches_by_kernel)
    stats = tier.stats()
    mem = torch.cuda.max_memory_allocated(dev)
    n_update = mod._optimizer.num_update
    if fused.captures != 1 or fused.eager_steps != 2 \
            or fused.replays != W * K - 2:
        raise RuntimeError("windows 2-%d fell back or recaptured: %d "
                           "captures, %d eager steps, %d replays"
                           % (W, fused.captures, fused.eager_steps,
                              fused.replays))
    if n_update != W * K:
        raise RuntimeError("update count %d after %d steps"
                           % (n_update, W * K))
    if launches != {"bn_act": 33 * 3, "bn_act_res": 16 * 3} \
            or stats["fallback"]:
        raise RuntimeError("B1 launches through the wrapper (2 warm-up "
                           "steps and the capture): %s, fallback %s"
                           % (launches, stats["fallback"]))
    bad = [k for k, v in mod._exec.arg_dict.items()
           if v.dtype != torch.float32]
    if bad:
        raise RuntimeError("master weights left f32: %s" % bad[:3])
    n_aux = check_moving_stats(mod, aux0)
    loss_k = window_losses(windows[:1], lab)
    rel = [abs(a - b) / abs(b) for a, b in zip(loss_k, loss1)]
    log("grouped ResNet-50 bf16, batch %d, K %d: losses of window 1 %s; "
        "K = 1 from the same start %s; relative %.3g at step 1, %.3g at "
        "worst" % (P["bf16_batch"], K, ["%.4f" % x for x in loss_k],
                   ["%.4f" % x for x in loss1], rel[0], max(rel)))
    if rel[0] > 5e-3 or max(rel) > 5e-2 or not falling(loss_k):
        raise RuntimeError("grouped losses against K = 1: %s" % rel)
    # -- two more windows under the profiler: the second one's census
    cen = graph_census(lambda: grouped_fit(mod, OneBatchIter(X, Y, K, dev),
                                           K))
    want = {"bn_act": 33 * K, "bn_act_res": 16 * K}
    got = {k: cen["counts"].get(k, 0) for k in want}
    log("  profiled window: %s B1 launches (%s per inner step), %.2f ms "
        "device of %.2f ms wall (busy %.1f%%); top %s"
        % (json.dumps(got), json.dumps({k: v / K for k, v in got.items()}),
           cen["device_ms"], cen["wall_ms"], 100 * cen["busy_share"],
           "; ".join(cen["top_kernels"][:5])))
    if got != want or cen["counts"].get("take_rows") \
            or cen["counts"].get("flash_attn"):
        raise RuntimeError("replayed window census %s, expected %s"
                           % (cen["counts"], want))
    step_ms = wall_ms / ((W - 1) * K)
    flops = RESNET50_TRAIN_FLOPS_PER_IMG * P["bf16_batch"]
    per_step = report["resnet_train"]["bf16"]["step_ms_p50"]
    log("grouped ResNet-50 bf16 train step, batch %d, K %d: %.2f ms (wall "
        "over windows 2-%d / %d), %.1f images/s, %.2f%% of the 989 TFLOP/s "
        "bf16 peak; phase 13's per-step p50 %.2f ms; busy %.1f%% "
        "(profiled window); peak memory %.2f GB; capture %.1f ms of window "
        "1's %.1f ms wall (2 warm-up steps, %d replays); %d moving "
        "statistics f32 and moved  [%s]"
        % (P["bf16_batch"], K, step_ms, W, (W - 1) * K,
           P["bf16_batch"] / (step_ms / 1e3),
           100 * flops / (step_ms / 1e3) / BF16_FLOPS, per_step,
           100 * cen["busy_share"], mem / 1e9, fused.capture_ms[0],
           first_ms, K - 2, n_aux, card))
    # -- fit's automatic K on defaults (eval_metric="acc"): the metric
    # folds into the step and K is MXNET_STEPS_PER_DISPATCH's 16
    sizes, real = [], mod._fit_group

    def spy(batches, *a, **kw):
        sizes.append(len(batches))
        return real(batches, *a, **kw)
    mod._fit_group = spy
    del windows[:]
    m_dev = mt.metric.Accuracy()
    grouped_fit(mod, OneBatchIter(X, Y, G["auto_batches"], dev), None,
                eval_metric=m_dev)
    dev_acc = m_dev.get()[1]
    hits = [(o[0].argmax(dim=2) == lab.view(1, -1)).sum().item()
            for o in windows]
    host_acc = sum(hits) / (G["auto_batches"] * P["bf16_batch"])
    log("  automatic K on defaults: %s (groups %s), device-resident "
        "accuracy %.6f, host accuracy of the same outputs %.6f"
        % (max(sizes or [1]), sizes, dev_acc, host_acc))
    if max(sizes or [1]) != G["auto_k"] or mod._device_plan is None \
            or abs(dev_acc - host_acc) > 1e-6:
        raise RuntimeError("automatic K %s (want %d), device metric %s "
                           "against host %s" % (sizes, G["auto_k"],
                                                dev_acc, host_acc))
    report["grouped"] = {
        "k": K, "windows": W, "step_ms": step_ms,
        "img_per_s": P["bf16_batch"] / (step_ms / 1e3),
        "model_flops_share_of_peak": flops / (step_ms / 1e3) / BF16_FLOPS,
        "per_step_ms_p50": per_step, "first_window_ms": first_ms,
        "capture_ms": list(fused.capture_ms), "peak_memory_bytes": mem,
        "census": cen, "losses": loss_k, "losses_k1": loss1,
        "loss_rel": rel, "auto_k": max(sizes), "device_acc": dev_acc,
        "host_acc": host_acc}
    # the graphs' pools hold a step's peak until they go
    fused.release_graphs()
    del mod, fused, windows
    report["grouped"]["allocated_after_bytes"] = released(dev)
    return launches, cen["counts"]


def grouped_gpt(dev, card, report):
    """Phase 8's GPT at GPT-2 small's widths cut to 2 layers, batch 8 x
    1024, Adam, tier auto: ``fit(steps_per_dispatch=4)`` against K = 1
    from the same Xavier weights (seed 0), with phase 9's bounds between
    tiers: losses within 1e-4 relative at every step, and the parameters
    within 1e-3, taken as the L2 norm of the two runs' difference over
    that of the K = 1 run's update, over the whole model; every update
    count 4. Then a replayed window's census: B2 1, B3 2 and B5 2 an
    inner step. The runs are not bitwise alike: B2's backward sums with
    atomics, in another order every run, so after step 1 a ReLU input
    near 0 may flip and Adam moves the elements it feeds by a part of lr
    (up to 4.8e-5 of the largest element difference in four runs). Adam
    runs at epsilon 1e-4: at the default an element whose gradient is
    float noise moves by +-lr whichever way the noise points. A
    hyperparameter frozen into the graph (Adam's t) would move every
    element by 10-30 % of its update."""
    G, P = GROUPED, GPT_TRAIN
    K = G["gpt_k"]
    net = mt.models.gpt_lm(P["vocab"], P["dim"], P["heads"],
                           G["gpt_layers"], P["seq_len"])
    X, Y = train_batches(K, P["batch"], P["seq_len"], P["vocab"], P["lag"])
    opt = (ADAM[0], dict(ADAM[1], epsilon=1e-4))
    init = mt.mod.Module(net, context=dev)
    init.bind([("data", (P["batch"], P["seq_len"]))],
              [("softmax_label", (P["batch"], P["seq_len"]))])
    init.init_params(mt.init.Xavier(seed=0))
    p0 = init.get_params()[0]
    del init
    ref, loss1, _st = fit_steps(net, X, Y, dev, P["batch"],
                                initializer=mt.init.Xavier(seed=0), opt=opt)
    want = {k: v.clone() for k, v in ref.get_params()[0].items()}
    del ref
    released(dev)
    reset_train_counts()
    mod = mt.mod.Module(net, context=dev)
    windows = window_recorder(mod)
    mod.fit(mt.io.NDArrayIter(X, Y, batch_size=P["batch"]), num_epoch=1,
            kvstore="tpu_sync", optimizer=opt[0], optimizer_params=opt[1],
            initializer=mt.init.Xavier(seed=0), eval_metric=None,
            steps_per_dispatch=K)
    torch.cuda.synchronize()
    counts = train_counts()
    lab = torch.from_numpy(Y).to(dev).long().view(K, P["batch"], -1)
    probs = windows[0][0].gather(3, lab.unsqueeze(3)).clamp_min(1e-30)
    loss_k = (-probs.log().mean(dim=(1, 2, 3))).tolist()
    del windows[:], probs
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(loss_k, loss1))
    fused, optim = mod._fused, mod._optimizer
    got = mod.get_params()[0]
    err = {k: float((got[k] - v).abs().max()) for k, v in want.items()}
    worst = max(err, key=err.get)
    part = math.sqrt(sum(float((got[k] - v).double().square().sum())
                         for k, v in want.items())
                     / sum(float((v - p0[k]).double().square().sum())
                           for k, v in want.items()))
    ts = sorted(set(optim._index_update_count.values()))
    log("grouped GPT (2 layers, batch %d x %d, Adam, tier auto), K %d "
        "against K = 1 from the same weights: losses %s and %s, within %.3g "
        "relative; parameters %.3g of the K = 1 update apart (L2 over the "
        "model), the largest element difference %.3g (%s); update counts "
        "%s; %d captured, %d eager (warm-up), %d replayed; launches "
        "through the wrappers %s"
        % (P["batch"], P["seq_len"], K, ["%.5f" % x for x in loss_k],
           ["%.5f" % x for x in loss1], loss_rel, part, err[worst],
           json.dumps({k: "%.3g" % err[k] for k in sorted(
               err, key=err.get)[-3:]}),
           ts, fused.captures, fused.eager_steps, fused.replays,
           json.dumps(counts)))
    if loss_rel > 1e-4 or part > 1e-3 or ts != [K] \
            or optim.num_update != K or fused.captures != 1 \
            or fused.replays != K - 2:
        raise RuntimeError("grouped GPT: losses %.3g, parameters %.3g from "
                           "K = 1, counts %s, %d captures, %d replays"
                           % (loss_rel, part, ts, fused.captures,
                              fused.replays))
    cen = graph_census(lambda: mod.fit(
        mt.io.NDArrayIter(X, Y, batch_size=P["batch"]), num_epoch=1,
        kvstore="tpu_sync", eval_metric=None, steps_per_dispatch=K))
    per = {k: cen["counts"].get(k, 0) / K
           for k in ("take_rows", "flash_attn", "scale_bias_act")}
    log("  replayed GPT window: per inner step %s, %.2f ms device of %.2f "
        "ms wall a step (busy %.1f%%)  [%s]"
        % (json.dumps(per), cen["device_ms"] / K, cen["wall_ms"] / K,
           100 * cen["busy_share"], card))
    L = G["gpt_layers"]
    if per != {"take_rows": 1, "flash_attn": L, "scale_bias_act": L} \
            or fused.replays != 3 * K - 2 or train_counts() != counts:
        raise RuntimeError("grouped GPT census %s (kernels %s), %d "
                           "replays, launches through the wrappers %s (a "
                           "replayed window launches none)"
                           % (cen["counts"], cen["names"], fused.replays,
                              train_counts()))
    fused.release_graphs()
    del mod, fused
    released(dev)
    report["grouped_gpt"] = {"k": K, "losses": loss_k, "losses_k1": loss1,
                             "param_part": part, "param_err": err[worst],
                             "census_per_step": per, "census": cen,
                             "launches": counts}
    return counts


def dropout_net():
    data = mt.sym.Variable("data")
    net = mt.sym.FullyConnected(data, num_hidden=256, name="fc1")
    net = mt.sym.Activation(net, act_type="relu")
    net = mt.sym.Dropout(net, p=0.5)
    net = mt.sym.FullyConnected(net, num_hidden=10, name="fc2")
    return mt.sym.SoftmaxOutput(net, name="softmax")


def grouped_dropout(dev, report):
    """A small f32 MLP with Dropout(0.5) trained by Adam grouped (K = 4)
    and per step from the same seed: losses and parameters bitwise equal
    (a mask, or Adam's bias correction, frozen into the graph would part
    them), and the key chain's state after both equal."""
    G = GROUPED
    rng = np.random.RandomState(0)
    n = G["drop_batches"] * G["drop_batch"]
    X = rng.randn(n, 64).astype(np.float32)
    Y = rng.randint(0, 10, (n,)).astype(np.float32)
    runs = {}
    for k in (1, G["drop_k"]):
        mod = mt.mod.Module(dropout_net(), context=dev)
        windows = window_recorder(mod)
        losses = []

        def record(p):
            if k == 1:
                out = mod.get_outputs()[0]
                lab = p.locals["data_batch"].label[0].to(dev).long()
                losses.append(out.gather(1, lab.unsqueeze(1)).log().mean())
        mt.random.seed(5)
        mod.fit(mt.io.NDArrayIter(X, Y, batch_size=G["drop_batch"]),
                num_epoch=1, kvstore="tpu_sync", optimizer="adam",
                optimizer_params={"learning_rate": 0.01},
                initializer=mt.init.Xavier(seed=0), eval_metric=None,
                steps_per_dispatch=k, batch_end_callback=record)
        if k > 1:
            labs = torch.from_numpy(Y).to(dev).long().view(
                -1, k, G["drop_batch"])
            for w, outs in enumerate(windows):
                p = outs[0].gather(2, labs[w].unsqueeze(2))
                losses.extend(p.log().mean(dim=(1, 2)).unbind())
        runs[k] = (torch.stack(losses).cpu(),
                   {n_: v.cpu() for n_, v in mod.get_params()[0].items()},
                   mt.random.get_state()[0].copy(), mod._fused.replays)
        del mod
    (l1, p1, c1, _r1), (lk, pk, ck, rk) = runs[1], runs[G["drop_k"]]
    same = torch.equal(l1, lk) and all(torch.equal(p1[k], pk[k])
                                       for k in p1)
    log("grouped Dropout MLP, K %d against K = 1 from seed 5: losses %s "
        "and %s, parameters %s, key chains %s and %s, %d replayed steps"
        % (G["drop_k"], ["%.5f" % x for x in l1.tolist()],
           "bitwise equal" if torch.equal(l1, lk) else "DIFFERENT",
           "bitwise equal" if same else "DIFFERENT", c1.tolist(),
           ck.tolist(), rk))
    if not same or not np.array_equal(c1, ck) or rk < G["drop_batches"] - 2:
        raise RuntimeError("grouped Dropout differs from per step: losses "
                           "%s vs %s" % (l1.tolist(), lk.tolist()))
    report["grouped_dropout"] = {"losses": l1.tolist(), "bitwise": same}


# ------------------------------------------------ recommend (phase 16)
# bench.py's recommend leg at its chip sizes (bench.py:_reco_leg, on_tpu)
RECO = {"users": 65536, "items": 4096, "dim": 64, "batch": 512,
        "steps": 30, "cache_rows": 8192, "lr": 0.1, "max_ids": 64, "k": 10,
        "requests": 256, "concurrency": 8, "mean_ids": 8, "zipf": 1.3}
# examples/matrix_factorization.py's defaults
MF = {"users": 200, "items": 150, "factor": 16, "batch": 256, "lr": 0.05,
      "epochs": 2, "ratings": 20000}


def b2_recommend_phase(dev):
    """B2 at the recommend path's shapes, bitwise against its plain
    version, out-of-range ids included: the served lookup's (1024, 64)
    cache by a (16 x 64) slot matrix, a (8192, 64) training cache by
    512 ids, and the matrix factorization's (200, 16) table by 256 ids.
    Then their times beside the plain gather, ``index_select`` of the
    clipped ids and the bound (the gathered rows read and written and
    the ids read, over the HBM rate)."""
    g = torch.Generator(device=dev).manual_seed(16)
    rows = {}
    b2_row(rows, "take_rows@serve", 1024, 64, (16, 64), dev, g)
    b2_row(rows, "take_rows@train", 8192, 64, (512,), dev, g)
    b2_row(rows, "take_rows@mf", MF["users"], MF["factor"], (MF["batch"],),
           dev, g)
    log("B2 at the recommend shapes: bitwise the plain gather")
    return rows


def b2_row(rows, name, V, D, idx_shape, dev, g):
    """B2 on a random (V, D) f32 table by int32 ids of ``idx_shape``
    (out-of-range ones included), bitwise against its plain version,
    then timed beside the plain gather, ``index_select`` of the clipped
    ids and the bound (the gathered rows read and written and the ids
    read, over the HBM rate) -> ``rows[name]``."""
    from mxnet_tpu_torch.kernels import take
    table = torch.randn(V, D, generator=g, device=dev)
    ids = torch.randint(-64, V + 64, idx_shape, generator=g, device=dev,
                        dtype=torch.int32)
    got = take.take_rows(table, ids)
    torch.cuda.synchronize()
    if not torch.equal(got, take._plain_take(table, ids)):
        raise RuntimeError("take_rows is not bitwise the clipped gather at "
                           "%s" % name)
    flat = ids.reshape(-1).contiguous()
    clipped = flat.long().clamp(0, V - 1)
    n = flat.numel()
    r = {"shape": "table (%d, %d) f32, ids %s" % (V, D, idx_shape),
         "ms": time_ms(lambda: take._launch(table, flat,
                                            take.DEFAULT_CONFIG), dev),
         "plain_ms": time_ms(lambda: take._plain_take(table, ids), dev),
         "library_ms": time_ms(
             lambda: torch.index_select(table, 0, clipped), dev),
         "bytes_ms": (2 * n * D * 4 + n * 4) / HBM_BYTES_PER_S * 1e3,
         "ops_ms": 0.0}
    r["bound_ms"], r["bound_by"] = bound_of(r["bytes_ms"], r["ops_ms"])
    rows[name] = r
    log("  %-22s %-40s ms=%.5f plain_ms=%.5f index_select_ms=%.5f "
        "bound_ms=%.6f (%s)" % (name, r["shape"], r["ms"], r["plain_ms"],
                                r["library_ms"], r["bound_ms"],
                                r["bound_by"]))
    return r


def reco_train_data():
    """bench.py's training stream, in its order: Zipf user ids, uniform
    item ids, normal ratings, all from RandomState(0)."""
    rng = np.random.RandomState(0)
    S, B = RECO["steps"], RECO["batch"]
    u_ids = ((rng.zipf(RECO["zipf"], size=(S, B)) - 1)
             % RECO["users"]).astype("int64")
    i_ids = rng.randint(0, RECO["items"], size=(S, B)).astype("int64")
    ratings = rng.randn(S, B).astype("f4")
    return u_ids, i_ids, ratings


def reco_step(u_buf, i_buf, us, isl, r, lr):
    """bench.py's two-tower step (bench.py:209-216) in torch, in place.
    Each row's contributions are summed before its one update, by
    ``index_put_(accumulate=True)`` under deterministic algorithms: a
    stable sort by row, then a sum in batch order, so the tables do not
    depend on which slot a row sits in (``index_add_``'s atomics would
    add Zipf's repeated ids in any order)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        uv, iv = u_buf[us], i_buf[isl]
        err = (uv * iv).sum(-1) - r
        d = (2.0 / r.shape[0]) * err
        gu = torch.zeros_like(u_buf).index_put_((us,), d[:, None] * iv,
                                                accumulate=True)
        gi = torch.zeros_like(i_buf).index_put_((isl,), d[:, None] * uv,
                                                accumulate=True)
        u_buf.sub_(lr * gu)
        i_buf.sub_(lr * gi)
        return (err ** 2).sum()
    finally:
        torch.use_deterministic_algorithms(prev)


def reco_train(dev, data, cached, profiled=False):
    """The 30 steps through the hot-row caches (``ensure`` before and
    ``note_updated`` after every step, ``flush`` at the end), or on
    dense tables on the card. Returns the final tables, the stores, the
    user cache, the wall ms a step over steps 2-30 and, when
    ``profiled``, their device ms a step from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.embed import HotRowCache, SpillStore, row_init
    u_ids, i_ids, ratings = data
    U, I, D = RECO["users"], RECO["items"], RECO["dim"]
    lr = float(np.float32(RECO["lr"]))
    r_dev = torch.from_numpy(ratings).to(dev)
    if cached:
        store_u, store_i = SpillStore(U, D, seed=1), SpillStore(I, D, seed=2)
        cache_u = HotRowCache(store_u, RECO["cache_rows"], device=dev)
        cache_i = HotRowCache(store_i, min(RECO["cache_rows"], I),
                              device=dev)
    else:
        u_tab = torch.from_numpy(row_init(1, np.arange(U), D)).to(dev)
        i_tab = torch.from_numpy(row_init(2, np.arange(I), D)).to(dev)

    def step(s):
        if cached:
            us = torch.from_numpy(cache_u.ensure(u_ids[s])).to(dev).long()
            isl = torch.from_numpy(cache_i.ensure(i_ids[s])).to(dev).long()
            loss = reco_step(cache_u.buf, cache_i.buf, us, isl, r_dev[s], lr)
            cache_u.note_updated(u_ids[s])
            cache_i.note_updated(i_ids[s])
            return loss
        us = torch.from_numpy(u_ids[s]).to(dev)
        isl = torch.from_numpy(i_ids[s]).to(dev)
        return reco_step(u_tab, i_tab, us, isl, r_dev[s], lr)

    losses = [step(0)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    device_ms = None
    if profiled:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for s in range(1, RECO["steps"]):
                losses.append(step(s))
            torch.cuda.synchronize()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)
        if busy <= 0:
            raise RuntimeError("torch.profiler recorded no device time")
        device_ms = busy / (RECO["steps"] - 1) / 1e3
    else:
        for s in range(1, RECO["steps"]):
            losses.append(step(s))
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / (RECO["steps"] - 1)
    losses = [float(x) for x in losses]
    if not cached:
        return (u_tab.cpu().numpy(), i_tab.cpu().numpy(), None, None,
                step_ms, device_ms, losses)
    cache_u.flush()
    cache_i.flush()
    return (store_u.peek(np.arange(U)), store_i.peek(np.arange(I)),
            (store_u, store_i), cache_u, step_ms, device_ms, losses)


def sample_lengths(rng, n, mean, lo, hi):
    """``tools/serve_loadgen.py`` ``_sample_lengths``'s longtail draw: a
    geometric tail around ``mean``, clipped to [lo, hi]."""
    mean = max(lo, min(mean, hi))
    p_geo = min(0.95, 1.0 / max(1.0, mean - lo + 1))
    vals = lo + rng.geometric(p=p_geo, size=n) - 1
    return np.clip(vals, lo, hi).astype(int)


def reco_requests():
    """``measure_recommend``'s requests (tools/serve_loadgen.py:784-880):
    RandomState(0), longtail lengths of mean 8 clipped to 1..64, Zipf
    ids."""
    rng = np.random.RandomState(0)
    lens = sample_lengths(rng, RECO["requests"], RECO["mean_ids"], 1,
                          RECO["max_ids"])
    return [((rng.zipf(RECO["zipf"], size=int(lens[i])) - 1)
             % RECO["users"]).astype("int64").tolist()
            for i in range(RECO["requests"])]


def closed_loop(srv, id_lists, concurrency):
    """``concurrency`` client threads, each submitting its next request
    when the last one returned. Returns the results, latencies (ms) and
    wall seconds; any failure raises."""
    lock = threading.Lock()
    nxt = [0]
    results = [None] * len(id_lists)
    lat = [None] * len(id_lists)
    errors = []

    def worker():
        while True:
            with lock:
                if nxt[0] >= len(id_lists):
                    return
                i = nxt[0]
                nxt[0] += 1
            t0 = time.monotonic()
            try:
                results[i] = srv.submit_recommend(id_lists[i]).result(
                    timeout=60)
            except Exception as e:     # reported below, with the index
                errors.append((i, repr(e)))
                return
            lat[i] = (time.monotonic() - t0) * 1e3
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t0
    if errors:
        raise RuntimeError("recommend requests failed: %s" % errors[:4])
    return results, lat, wall


def reco_serve_run(srv, id_lists):
    """The traffic once through ``srv`` in a closed loop, the counts
    zeroed just before and read just after: one B2 launch and one
    dispatch per executed batch, no fallback, one device-to-host copy
    per batch, the cache buffer in place. Returns the results and the
    run's numbers."""
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.kernels import take
    ptr = srv.engine.cache.buf.data_ptr()
    before = {b: v["batches"] for b, v in srv.metrics()["buckets"].items()}
    reset_train_counts()
    profiler.reset_sync_counters()
    results, lat, wall = closed_loop(srv, id_lists, RECO["concurrency"])
    launches, st = take.launches, tier.stats()
    syncs = profiler.sync_counters()
    by_bucket = {b: v["batches"] - before.get(b, 0)
                 for b, v in srv.metrics()["buckets"].items()}
    batches = sum(by_bucket.values())
    if launches != batches or st["dispatch"].get("take_rows") != batches \
            or st["fallback"]:
        raise RuntimeError("recommend: %d B2 launches for %d batches, tier "
                           "%s" % (launches, batches, st))
    if syncs["d2h"] != batches:
        raise RuntimeError("recommend: %d device-to-host copies for %d "
                           "batches" % (syncs["d2h"], batches))
    if srv.engine.cache.buf.data_ptr() != ptr:
        raise RuntimeError("recommend: the cache buffer moved")
    return results, {
        "goodput_qps": len(results) / wall, "wall_s": wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)), "batches": batches,
        "buckets": by_bucket, "take_rows_launches": launches,
        "d2h": syncs["d2h"], "d2h_bytes": syncs["d2h_bytes"]}


def reco_oracle_check(user, corpus, id_lists, results):
    """Every response against a float64 numpy oracle on the exported
    tables: the mean of the request's user rows (its first 64 ids), the
    corpus scores, a stable descending top 10. The items must be the
    oracle's, rank for rank, save near ties: a returned item whose
    oracle score is within rtol 1e-5 of the oracle's at that rank (the
    10th against the 11th, or two ranks inside the 10). The scores
    within rtol 1e-5. Returns (worst relative score error, requests
    with a near-tie swap)."""
    k = RECO["k"]
    c64 = corpus.astype(np.float64)
    worst, swaps = 0.0, 0
    for j, (ids, (scores, items)) in enumerate(zip(id_lists, results)):
        vec = user[np.asarray(ids[:RECO["max_ids"]])].astype(
            np.float64).mean(0)
        s = c64 @ vec
        want = np.argsort(-s, kind="stable")[:k]
        items = np.asarray(items, np.int64)
        if not np.array_equal(items, want):
            if len(set(items.tolist())) != k or not np.allclose(
                    s[items], s[want], rtol=1e-5, atol=0):
                raise RuntimeError(
                    "recommend request %d: items %s, oracle %s (scores %s "
                    "against %s)" % (j, items.tolist(), want.tolist(),
                                     s[items].tolist(), s[want].tolist()))
            swaps += 1
        err = float(np.max(np.abs(scores - s[want]) / np.abs(s[want])))
        if err > 1e-5:
            raise RuntimeError("recommend request %d: scores %.3g from the "
                               "oracle's (rtol 1e-5)" % (j, err))
        worst = max(worst, err)
    return worst, swaps


class MFBlock(mt.gluon.HybridBlock):
    """examples/matrix_factorization.py's block: two embeddings with
    row-sparse gradients, scored by a dot product."""

    def __init__(self, num_users, num_items, factor, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.user = mt.gluon.nn.Embedding(num_users, factor,
                                              sparse_grad=True)
            self.item = mt.gluon.nn.Embedding(num_items, factor,
                                              sparse_grad=True)

    def hybrid_forward(self, F, users, items):
        return (self.user(users) * self.item(items)).sum(axis=1)


def mf_ratings(num_users=200, num_items=150, rank=6, n=20000, seed=0):
    """examples/matrix_factorization.py's synthetic ratings."""
    rng = np.random.RandomState(seed)
    U = rng.randn(num_users, rank) / np.sqrt(rank)
    V = rng.randn(num_items, rank) / np.sqrt(rank)
    u = rng.randint(0, num_users, n)
    i = rng.randint(0, num_items, n)
    r = (U[u] * V[i]).sum(1) + 0.05 * rng.randn(n)
    return u.astype("f4"), i.astype("f4"), r.astype("f4")


def mf_net(ctx):
    net = MFBlock(MF["users"], MF["items"], MF["factor"])
    net.initialize(mt.init.Normal(0.1), ctx=ctx)
    trainer = mt.gluon.Trainer(net.collect_params(), "groupadagrad",
                               {"learning_rate": MF["lr"]})
    return net, trainer


def mf_step(net, trainer, loss_fn, ctx, u, i, r):
    users, items = mt.nd.array(u, ctx=ctx), mt.nd.array(i, ctx=ctx)
    score = mt.nd.array(r, ctx=ctx)
    with mt.autograd.record():
        pred = net(users, items)
        loss = loss_fn(pred, score)
    loss.backward()
    grads = [p.grad().asnumpy() for p in (net.user.weight,
                                           net.item.weight)]
    trainer.step(len(u))
    return pred, score, grads


def mf_phase(dev, report):
    """The matrix factorization example on the card: one step against
    the same step on the CPU (within 1e-5), the rows of zero gradient
    bitwise unchanged, then two epochs (batches of 256 in order) whose
    RMSE must fall, with 2 B2 launches a forward."""
    from mxnet_tpu_torch.kernels import take
    u, i, r = mf_ratings()
    B = MF["batch"]
    loss_fn = mt.gluon.loss.L2Loss()
    mt.random.seed(0)
    net, trainer = mf_net(mt.gpu(0))
    cpu_net, cpu_trainer = mf_net(mt.cpu())
    weights = (net.user.weight, net.item.weight)
    for p, q in zip(weights, (cpu_net.user.weight, cpu_net.item.weight)):
        q.set_data(mt.nd.array(p.data().asnumpy(), ctx=mt.cpu()))
    before = [p.data().asnumpy() for p in weights]
    _, _, grads = mf_step(net, trainer, loss_fn, mt.gpu(0), u[:B], i[:B],
                          r[:B])
    with mt.cpu():
        mf_step(cpu_net, cpu_trainer, loss_fn, mt.cpu(), u[:B], i[:B],
                r[:B])
    step_err = 0.0
    for p, q, w0, g in zip(weights, (cpu_net.user.weight,
                                     cpu_net.item.weight), before, grads):
        w = p.data().asnumpy()
        step_err = max(step_err, float(np.abs(w - q.data().asnumpy()).max()))
        zero = ~g.any(axis=1)
        if not np.array_equal(w[zero], w0[zero]):
            raise RuntimeError("the lazy update moved a row of zero gradient")
        if not (w[~zero] != w0[~zero]).any(axis=1).all():
            raise RuntimeError("the lazy update left a touched row alone")
    if step_err > 1e-5:
        raise RuntimeError("matrix factorization step: card vs CPU %.3g "
                           "(limit 1e-5)" % step_err)
    n_batches = MF["ratings"] // B
    reset_train_counts()
    rmse, forwards = [], 0
    t0 = time.perf_counter()
    for _ in range(MF["epochs"]):
        se = 0.0
        for b in range(n_batches):
            sl = slice(b * B, (b + 1) * B)
            pred, score, _ = mf_step(net, trainer, loss_fn, mt.gpu(0),
                                     u[sl], i[sl], r[sl])
            se += float(((pred - score) ** 2).sum().asscalar())
            forwards += 1
        rmse.append(math.sqrt(se / (n_batches * B)))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / forwards
    launches = take.launches
    st = tier.stats()
    if launches != 2 * forwards or st["dispatch"].get("take_rows") \
            != 2 * forwards or st["fallback"]:
        raise RuntimeError("matrix factorization: %d B2 launches for %d "
                           "forwards (want 2 each), tier %s"
                           % (launches, forwards, st))
    if not rmse[1] < rmse[0]:
        raise RuntimeError("matrix factorization: RMSE did not fall: %s"
                           % rmse)
    report["matrix_factorization"] = {
        "rmse_by_epoch": rmse, "step_ms": step_ms, "forwards": forwards,
        "take_rows_launches": launches, "card_vs_cpu_step": step_err}
    log("matrix factorization (200 x 150, factor 16, groupadagrad, batch "
        "256): one step card vs CPU %.3g; zero-gradient rows unchanged; "
        "RMSE %s over 2 epochs; %.3f ms a step (the loop's host copy "
        "included); B2 %d launches for %d forwards"
        % (step_err, " -> ".join("%.4f" % x for x in rmse), step_ms,
           launches, forwards))
    return launches


def recommend_path(dev, card, report):
    """Phase 16: bench.py's recommend leg on the card (see the module
    docstring); returns B2's rows and its launches on both paths."""
    import tempfile
    from mxnet_tpu_torch.embed.serve import export_recommend
    log("phase 16: recommend (bench.py's reco leg at its chip sizes)")
    rows = b2_recommend_phase(dev)
    data = reco_train_data()
    t0 = time.perf_counter()
    u_c, i_c, stores, cache_u, step_ms, _, losses = reco_train(
        dev, data, cached=True)
    u_p, i_p, _, _, _, dev_ms, _ = reco_train(dev, data, cached=True,
                                              profiled=True)
    u_d, i_d, _, _, _, _, _ = reco_train(dev, data, cached=False)
    train_s = time.perf_counter() - t0
    if not (np.array_equal(u_c, u_p) and np.array_equal(i_c, i_p)):
        raise RuntimeError("two runs of the cached training differ: the "
                           "step is not deterministic")
    if not (np.array_equal(u_c, u_d) and np.array_equal(i_c, i_d)):
        raise RuntimeError("cached and dense training differ (max %.3g)"
                           % max(np.abs(u_c - u_d).max(),
                                 np.abs(i_c - i_d).max()))
    cst = cache_u.stats()
    if cst["spill_bytes"] <= 0:
        raise RuntimeError("the training cache never spilled")
    train = {"step_ms": step_ms, "device_ms": dev_ms, "losses": losses,
             "cache": {k: cst[k] for k in ("hit_rate", "evictions",
                                           "spill_bytes", "upload_bytes")},
             "three_runs_s": train_s}
    log("two-tower training (%d x %d users, %d items, cache %d, %d steps "
        "of %d): %.3f ms a step (steps 2-%d), %.4f ms of device time; user "
        "cache %s; loss %.4f -> %.4f; bitwise across two cached runs and "
        "the dense tables  [%s]"
        % (RECO["users"], RECO["dim"], RECO["items"], RECO["cache_rows"],
           RECO["steps"], RECO["batch"], step_ms, RECO["steps"], dev_ms,
           json.dumps(train["cache"]), losses[0], losses[-1], card))

    art = os.path.join(tempfile.mkdtemp(prefix="reco_"), "twotower.mxtorch")
    store_u, store_i = stores
    export_recommend(store_u.peek(np.arange(RECO["users"])),
                     store_i.peek(np.arange(RECO["items"])), art,
                     max_ids=RECO["max_ids"], k=RECO["k"])
    srv = mt.serve.Server(art, queue_depth=64)
    eng = srv.engine
    id_lists = reco_requests()
    # as bench.py measures it, the first requests meet a cold server (the
    # batcher thread's first products, sorts and pinned copies); then
    # the same traffic again on the warm one
    runs = {}
    for name in ("cold", "warm"):
        results, runs[name] = reco_serve_run(srv, id_lists)
        worst, swaps = reco_oracle_check(eng.model.user_table,
                                         eng.model.item_table, id_lists,
                                         results)
        runs[name].update(oracle_worst_rel_err=worst, near_tie_swaps=swaps,
                          engine_stats=eng.stats())
    srv.close(drain=True)
    diags = eng.check_discipline()
    if diags:
        raise RuntimeError("recommend discipline: %s" % diags)
    lists16 = id_lists[:16]
    prof = profile_steps(lambda: eng.recommend_batch(lists16), 20, 5)
    report["recommend"] = {"train": train, "serve": runs,
                           "batch16_profile": prof}
    for name, r in runs.items():
        st = r["engine_stats"]
        log("recommend serving, %s (Server, buckets %s, cache %d): %d "
            "requests at concurrency %d: %.1f QPS, p50 %.3f ms, p99 %.3f "
            "ms; %d batches %s, %d B2 launches, %d d2h (%d bytes); every "
            "answer the oracle's (worst score rel err %.3g, %d near-tie "
            "swaps); engine stats after: hit rate %.4f, evictions %d, "
            "upload %d bytes; buffer in place  [%s]"
            % (name, list(eng.buckets), eng.cache.capacity, len(id_lists),
               RECO["concurrency"], r["goodput_qps"], r["p50_ms"],
               r["p99_ms"], r["batches"], json.dumps(r["buckets"]),
               r["take_rows_launches"], r["d2h"], r["d2h_bytes"],
               r["oracle_worst_rel_err"], r["near_tie_swaps"],
               st["hit_rate"], st["evictions"], st["upload_bytes"], card))
    log("  discipline clean; a batch of 16 through the engine: %.3f ms "
        "wall, %.4f ms device (busy %.1f %%); top kernels %s"
        % (prof["step_ms"], prof["device_ms"],
           100 * prof["device_busy_share"],
           json.dumps([(k["name"][:40], round(k["ms_per_step"], 4))
                       for k in prof["top_kernels"][:4]])))
    mf_launches = mf_phase(dev, report)
    return rows, {"recommend": sum(r["take_rows_launches"]
                                   for r in runs.values()),
                  "matrix_factorization": mf_launches}


# ------------------------------------------- recurrent networks (phase 17)
# (a) tools/bench_lstm.py's shape, the BASELINE metric's own
LSTM_BENCH = {"vocab": 10000, "hidden": 200, "layers": 2, "batch": 32,
              "seq_len": 35, "steps": 10, "lr": 0.1}
# (b) the upstream word language model's "medium" widths (emsize = nhid
# = 650, 2 layers, dropout 0.5, tied, bptt 35, batch 32, PTB's 10000
# words) through examples/word_language_model.py's model and loop (its
# lr and clip defaults)
WORD_LM = {"vocab": 10000, "emsize": 650, "nhid": 650, "layers": 2,
           "dropout": 0.5, "tied": True, "bptt": 35, "batch": 32,
           "steps": 10, "lr": 2.0, "clip": 0.25}
# examples/char_lstm.py at its defaults, its corpus copied from its source
CHAR_CORPUS = ("the quick brown fox jumps over the lazy dog. "
               "pack my box with five dozen liquor jugs. ") * 40
CHAR_LSTM = {"batch": 16, "epochs": 3, "hidden": 64, "embed": 32,
             "buckets": [13, 25], "lr": 3e-3}


def lstm_flops(T, N, inp, hid, layers, vocab):
    """Model FLOPs of one training step (forward x 3): the LSTM's input
    and recurrent products and the decoder's product."""
    fwd = 0
    for layer in range(layers):
        i = inp if layer == 0 else hid
        fwd += 2 * T * N * 4 * hid * (i + hid)
    fwd += 2 * T * N * hid * vocab
    return 3 * fwd


def b2_rnn_counts():
    from mxnet_tpu_torch.kernels import take
    take.reset_launches()
    tier.reset_stats()


def b2_rnn_read(what, steps, per_step=1):
    """B2's launches since b2_rnn_counts: ``per_step`` a step, none
    through a fallback."""
    from mxnet_tpu_torch.kernels import take
    st = tier.stats()
    if st["fallback"]:
        raise RuntimeError("%s: kernel-tier fallback %s" % (what,
                                                            st["fallback"]))
    if take.launches != per_step * steps:
        raise RuntimeError("%s: %d B2 launches in %d steps, expected %d a "
                           "step" % (what, take.launches, steps, per_step))
    if st["dispatch"].get("take_rows", 0) != take.launches:
        raise RuntimeError("%s: B2 dispatched %s times, launched %d"
                           % (what, st["dispatch"].get("take_rows"),
                              take.launches))
    return take.launches


def step_split(step):
    """Forward, backward and update of ``step(ev)`` by CUDA events (the
    step records ``ev[0..3]`` around them), the median of 3, with the
    wall time."""
    parts = []
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(ev)
        torch.cuda.synchronize()
        parts.append((ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2]),
                      ev[2].elapsed_time(ev[3]),
                      (time.perf_counter() - t0) * 1e3))
    med = [float(np.median([p[i] for p in parts])) for i in range(4)]
    return {"forward_ms": med[0], "backward_ms": med[1],
            "update_ms": med[2], "wall_ms": med[3]}


def rnn_timed(step, steps, tokens):
    """``steps`` synced steps (wall p50, tokens/s), after which the
    split, torch.profiler's device ms, busy share and launches a step,
    and the peak memory of the timed steps."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(steps):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 1e9
    r = {"step_ms_p50": float(np.median(walls)),
         "tokens_per_s": tokens * steps / (sum(walls) / 1e3),
         "peak_gb": peak, "walls_ms": walls}
    r.update(step_split(step))
    prof = profile_steps(step, 2, 3)
    r.update({k: prof[k] for k in ("device_ms", "device_busy_share",
                                   "kernel_launches", "top_kernels",
                                   "top_host_ops")})
    return r


def log_rnn(what, r, flops, b2, card):
    log("%s: %.0f tokens/s, step p50 %.2f ms (wall); device %.3f ms a step, "
        "busy %.1f %%; %.0f kernel launches a step (torch.profiler), B2 %d "
        "a step; forward %.2f / backward %.2f / update %.2f ms (CUDA "
        "events); peak memory %.3f GB; model FLOPs %.3g a step = %.4f ms at "
        "67 TFLOP/s f32 (%.2f %% of the step)  [%s]"
        % (what, r["tokens_per_s"], r["step_ms_p50"], r["device_ms"],
           100 * r["device_busy_share"], r["kernel_launches"], b2,
           r["forward_ms"], r["backward_ms"], r["update_ms"], r["peak_gb"],
           flops, flops / F32_FLOPS * 1e3,
           100 * flops / F32_FLOPS * 1e3 / r["step_ms_p50"], card))
    log("  top kernels %s" % json.dumps(
        [(k["name"][:40], round(k["ms_per_step"], 4), k["calls"])
         for k in r["top_kernels"][:5]]))


def cudnn_yardstick(flat, mode_args, x, h0, c0, dev, what):
    """cuDNN's LSTM (``torch.nn.LSTM``, not on the path) with the port's
    weights: its outputs against the port's RNN op on the same input
    (f32, TF32 off, within 1e-5 of the largest magnitude), and both
    forward + backward timed (CUDA events, median of 5)."""
    from mxnet_tpu_torch.ops import nn as tnn
    H, L = mode_args["state_size"], mode_args["num_layers"]
    T, N, I = x.shape
    lstm = torch.nn.LSTM(I, H, num_layers=L).to(dev)
    pieces = dict(zip(tnn._rnn_param_names(L, False), tnn._unpack_rnn_params(
        flat.detach(), "lstm", I, H, L, False)))
    with torch.no_grad():
        for layer in range(L):
            for theirs, ours in (("weight_ih", "i2h_weight"),
                                 ("weight_hh", "h2h_weight"),
                                 ("bias_ih", "i2h_bias"),
                                 ("bias_hh", "h2h_bias")):
                getattr(lstm, "%s_l%d" % (theirs, layer)).copy_(
                    pieces["l%d_%s" % (layer, ours)])
    fl = flat.detach().clone().requires_grad_(True)
    xs = x.detach().clone().requires_grad_(True)
    ours = tnn.rnn(xs, fl, h0, c0, state_outputs=True, **mode_args)
    theirs = lstm(xs, (h0, c0))
    pairs = [(ours[0], theirs[0]), (ours[1], theirs[1][0]),
             (ours[2], theirs[1][1])]
    err = max(float((a - b).abs().max().detach()
                    / b.abs().max().clamp_min(1e-30).detach())
              for a, b in pairs)
    if not err < 1e-5:
        raise RuntimeError("%s: the port's LSTM and cuDNN's differ by %.3g "
                           "of the largest magnitude" % (what, err))
    cot = torch.randn_like(ours[0])

    def port_fb():
        out = tnn.rnn(xs, fl, h0, c0, **mode_args)
        torch.autograd.grad(out, (xs, fl), cot)

    def cudnn_fb():
        out = lstm(xs, (h0, c0))[0]
        torch.autograd.grad(out, [xs] + list(lstm.parameters()), cot)

    def ev_ms(fn):
        for _ in range(2):
            fn()
        ts = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            fn()
            b.record()
            torch.cuda.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))
    r = {"shape": "T %d, N %d, I %d, H %d, %d layers" % (T, N, I, H, L),
         "rel_err": err, "port_fwd_bwd_ms": ev_ms(port_fb),
         "cudnn_fwd_bwd_ms": ev_ms(cudnn_fb)}
    log("  yardstick, not on the path: cuDNN's torch.nn.LSTM with the same "
        "weights at %s: outputs and states within %.2g of the port's "
        "(relative to the largest); forward + backward %.3f ms, the port's "
        "RNN op %.3f ms (%.1fx)" % (r["shape"], err, r["cudnn_fwd_bwd_ms"],
                                    r["port_fwd_bwd_ms"],
                                    r["port_fwd_bwd_ms"]
                                    / r["cudnn_fwd_bwd_ms"]))
    return r


def lstm_flat(rnn, layers):
    """A gluon.rnn.LSTM's parameters in the fused op's flat order."""
    from mxnet_tpu_torch.ops import nn as tnn
    return torch.cat([getattr(rnn, n).data()._data.reshape(-1)
                      for n in tnn._rnn_param_names(layers, False)])


def lstm_bench_path(dev, card):
    """(a): tools/bench_lstm.py's net and loop on the card."""
    P = LSTM_BENCH
    ctx = mt.gpu(0)
    gluon = mt.gluon
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Embedding(P["vocab"], P["hidden"]))
    rnn = gluon.rnn.LSTM(P["hidden"], num_layers=P["layers"], layout="NTC")
    net.add(rnn)
    net.add(gluon.nn.Dense(P["vocab"], flatten=False))
    net.initialize(mt.init.Xavier(), ctx=ctx)
    net.hybridize(static_alloc=True)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": P["lr"]})
    rng = np.random.RandomState(0)
    shape = (P["batch"], P["seq_len"])
    data = mt.nd.array(rng.randint(0, P["vocab"], shape), ctx=ctx)
    label = mt.nd.array(rng.randint(0, P["vocab"], shape), ctx=ctx)

    def step(ev=None):
        if ev:
            ev[0].record()
        with mt.autograd.record():
            out = net(data)
            loss = loss_fn(out, label)
        if ev:
            ev[1].record()
        loss.backward()
        if ev:
            ev[2].record()
        trainer.step(P["batch"])
        if ev:
            ev[3].record()
        return loss

    loss0 = step()      # warm-up (and the deferred shapes)
    states = rnn.begin_state(P["batch"], ctx=ctx)
    want = [(P["layers"], P["batch"], P["hidden"])] * 2
    if [tuple(x.shape) for x in states] != want:
        raise RuntimeError("LSTM.begin_state shapes %s, expected %s"
                           % ([tuple(x.shape) for x in states], want))
    # tokens/s as bench_lstm.py measures it: 10 steps, one sync at the end
    b2_rnn_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(P["steps"]):
        loss = step()
    last = float(loss.asnumpy().mean())
    dt = time.perf_counter() - t0
    b2 = b2_rnn_read("(a) bench_lstm", P["steps"])
    tokens = P["batch"] * P["seq_len"]
    if not (np.isfinite(last) and np.isfinite(
            float(loss0.asnumpy().mean()))):
        raise RuntimeError("(a): loss not finite")
    r = rnn_timed(step, P["steps"], tokens)
    r.update(bench_tokens_per_s=tokens * P["steps"] / dt,
             loss_first=float(loss0.asnumpy().mean()), loss_last=last,
             b2_launches=b2)
    flops = lstm_flops(P["seq_len"], P["batch"], P["hidden"], P["hidden"],
                       P["layers"], P["vocab"])
    log("(a) tools/bench_lstm.py's shape (Embedding(10000, 200) -> LSTM(200, "
        "2 layers, NTC) -> Dense(10000), Xavier, hybridized, SGD lr 0.1, "
        "batch 32 x 35): bench_lstm.py's way %.0f tokens/s (10 steps, one "
        "sync); loss %.4f -> %.4f"
        % (r["bench_tokens_per_s"], r["loss_first"], r["loss_last"]))
    log_rnn("(a)", r, flops, b2 // P["steps"], card)
    r["flops"] = flops
    flat = lstm_flat(rnn, P["layers"])
    g = torch.Generator(device=dev).manual_seed(17)
    x = torch.randn(P["seq_len"], P["batch"], P["hidden"], generator=g,
                    device=dev)
    h0 = torch.zeros(P["layers"], P["batch"], P["hidden"], device=dev)
    r["cudnn"] = cudnn_yardstick(flat, dict(
        state_size=P["hidden"], num_layers=P["layers"], mode="lstm"),
        x, h0, h0.clone(), dev, "(a)")
    return r


def word_lm_model(ctx):
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from gluon_lstm_lm import rnn_model_class
    P = WORD_LM
    model = rnn_model_class(mt.gluon)(P["vocab"], P["emsize"], P["nhid"],
                                      P["layers"], P["dropout"], P["tied"])
    model.initialize(mt.init.Xavier(), ctx=ctx)
    return model


def word_lm_path(dev, card):
    """(b): examples/word_language_model.py's RNNModel and loop at the
    upstream medium widths; one step against the CPU first."""
    P = WORD_LM
    ctx = mt.gpu(0)
    model = word_lm_model(ctx)
    from gluon_lstm_lm import lm_step
    B_, T = P["batch"], P["bptt"]
    rng = np.random.RandomState(0)
    toks = rng.randint(0, P["vocab"], (B_, T * (P["steps"] + 8) + 1)) \
        .astype("f4")
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    hidden = model.begin_state(B_, ctx)
    want = [(P["layers"], B_, P["nhid"])] * 2
    if [tuple(x.shape) for x in hidden] != want:
        raise RuntimeError("RNNModel.begin_state shapes %s, expected %s"
                           % ([tuple(x.shape) for x in hidden], want))
    if model.decoder.weight is not model.encoder.weight:
        raise RuntimeError("(b): the decoder is not tied to the encoder")
    with mt.autograd.predict_mode():
        out, st = model(mt.nd.array(toks[:, :T], ctx=ctx), hidden)
    if [tuple(x.shape) for x in st] != want or \
            tuple(out.shape) != (B_, T, P["vocab"]):
        raise RuntimeError("(b): forward shapes %s %s" % (
            tuple(out.shape), [tuple(x.shape) for x in st]))
    rel = {n[len(model.prefix):]: p
           for n, p in model.collect_params().items()}
    snap = {k: p.data()._data.detach().cpu().clone() for k, p in rel.items()}

    # one step on the card against the same step on the CPU
    cpu_model = word_lm_model(mt.cpu())
    cpu_model.rnn._layer_infer_shape((B_, T, P["emsize"]))
    cpu_model.decoder._layer_infer_shape((B_, T, P["nhid"]))
    cpu_rel = {n[len(cpu_model.prefix):]: p
               for n, p in cpu_model.collect_params().items()}
    for k, p in cpu_rel.items():
        p.set_data(mt.nd.NDArray(snap[k].clone()))
    res = {}
    for where, m, c, r_ in (("card", model, ctx, rel),
                            ("cpu", cpu_model, mt.cpu(), cpu_rel)):
        tr = mt.gluon.Trainer(m.collect_params(), "sgd",
                              {"learning_rate": P["lr"]})
        mt.random.seed(29)
        h = m.begin_state(B_, c)
        loss, _ = lm_step(mt.gluon, mt.autograd, m, tr, loss_fn,
                          mt.nd.array(toks[:, :T], ctx=c),
                          mt.nd.array(toks[:, 1:T + 1], ctx=c), h,
                          P["clip"], B_, c)
        res[where] = (loss.asnumpy().astype(np.float64),
                      {k: p.data()._data.detach().cpu().double()
                       for k, p in r_.items()})
    lerr = float(np.abs(res["card"][0] - res["cpu"][0]).max()
                 / np.abs(res["cpu"][0]).max())
    perr = {k: float((res["card"][1][k] - v).abs().max()
                     / v.abs().max().clamp_min(1e-30))
            for k, v in res["cpu"][1].items()}
    moved = {k: float((res["cpu"][1][k] - snap[k].double()).abs().max())
             for k in snap}
    worst = max(perr.values())
    if not (lerr < 1e-4 and worst < 1e-4):
        raise RuntimeError("(b): the card's step differs from the CPU's: "
                           "loss %.3g, parameters %s" % (lerr, perr))
    if min(moved.values()) <= 0:
        raise RuntimeError("(b): a parameter did not move: %s" % moved)
    log("(b) one step (dropout 0.5 on, the key chain seeded alike) on the "
        "card against the CPU: loss within %.2g, every parameter within "
        "%.2g relative to its largest magnitude" % (lerr, worst))
    del cpu_model, cpu_rel, res
    for k, p in rel.items():
        p.set_data(mt.nd.NDArray(snap[k].to(dev)))

    trainer = mt.gluon.Trainer(model.collect_params(), "sgd",
                               {"learning_rate": P["lr"]})
    state = {"hidden": model.begin_state(B_, ctx), "b": 0, "losses": []}

    def step(ev=None):
        b = state["b"] % (P["steps"] + 7)
        state["b"] += 1
        X = mt.nd.array(toks[:, b * T:(b + 1) * T], ctx=ctx)
        Y = mt.nd.array(toks[:, b * T + 1:(b + 1) * T + 1], ctx=ctx)
        hidden = [x.detach() for x in state["hidden"]]
        if ev:
            ev[0].record()
        with mt.autograd.record():
            out, hidden = model(X, hidden)
            loss = loss_fn(out, Y)
        if ev:
            ev[1].record()
        loss.backward()
        if ev:
            ev[2].record()
        grads = [p.grad(ctx) for p in model.collect_params().values()
                 if p.grad_req != "null"]
        mt.gluon.utils.clip_global_norm(grads, P["clip"] * B_)
        trainer.step(B_)
        if ev:
            ev[3].record()
        state["hidden"] = hidden
        # the example reads the loss every step
        state["losses"].append(float(loss.sum().asscalar()))

    step()              # warm-up
    b2_rnn_counts()
    n0 = state["b"]
    r = rnn_timed(step, P["steps"], B_ * T)
    calls = state["b"] - n0
    b2 = b2_rnn_read("(b) word LM", calls)
    r["b2_launches"] = b2
    if not all(np.isfinite(state["losses"])):
        raise RuntimeError("(b): loss not finite")
    flops = lstm_flops(T, B_, P["emsize"], P["nhid"], P["layers"],
                       P["vocab"])
    r.update(flops=flops, card_vs_cpu={"loss": lerr, "params": worst},
             losses=state["losses"])
    log("(b) examples/word_language_model.py's RNNModel at the upstream "
        "medium widths (emsize = nhid = 650, 2 layers, dropout 0.5, tied, "
        "bptt 35, batch 32, vocab 10000; SGD lr %g, clip %g; eager, as the "
        "example runs it): B2 launches only for the encoder (the tied "
        "decoder reads the same weight through its product)"
        % (P["lr"], P["clip"]))
    log_rnn("(b)", r, flops, b2 // calls, card)
    # the yardstick at (b)'s LSTM, without dropout (cuDNN draws its own)
    rnn = model.rnn
    flat = lstm_flat(rnn, P["layers"])
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(T, B_, P["emsize"], generator=g, device=dev)
    h0 = torch.randn(P["layers"], B_, P["nhid"], generator=g, device=dev)
    r["cudnn"] = cudnn_yardstick(flat, dict(
        state_size=P["nhid"], num_layers=P["layers"], mode="lstm"),
        x, h0, torch.randn_like(h0), dev, "(b)")
    return r


def char_lstm_path(dev, card):
    """examples/char_lstm.py at its defaults on the card: its corpus and
    buckets, mx.rnn.LSTMCell, BucketingModule, Xavier, Adam, Perplexity
    (ignore_label 0), 3 epochs; the perplexity must fall."""
    import logging
    import random as pyrandom
    P = CHAR_LSTM
    vocab = {c: i + 1 for i, c in enumerate(sorted(set(CHAR_CORPUS)))}
    ids = [vocab[c] for c in CHAR_CORPUS]
    sentences, i = [], 0
    for step in [24, 12] * (len(ids) // 36 + 1):
        if i + step + 1 > len(ids):
            break
        sentences.append(ids[i:i + step + 1])
        i += step
    n_vocab = len(vocab) + 1
    pyrandom.seed(0)
    np.random.seed(0)
    it = mt.rnn.BucketSentenceIter(sentences, P["batch"],
                                   buckets=list(P["buckets"]),
                                   invalid_label=0)

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        embed = mt.sym.Embedding(data, input_dim=n_vocab,
                                 output_dim=P["embed"], name="embed")
        cell = mt.rnn.LSTMCell(P["hidden"], prefix="lstm_")
        outs, _ = cell.unroll(seq_len, inputs=embed, layout="NTC",
                              merge_outputs=True)
        pred = mt.sym.Reshape(outs, shape=(-1, P["hidden"]))
        pred = mt.sym.FullyConnected(pred, num_hidden=n_vocab, name="pred")
        label = mt.sym.Reshape(label, shape=(-1,))
        return (mt.sym.SoftmaxOutput(pred, label, name="softmax",
                                     use_ignore=True, ignore_label=0),
                ("data",), ("softmax_label",))

    mod = mt.mod.BucketingModule(sym_gen,
                                 default_bucket_key=it.default_bucket_key,
                                 context=mt.gpu(0))
    metric = mt.metric.Perplexity(ignore_label=0)
    ppl, steps = [], [0]

    def batch_end(param):
        steps[0] += 1

    def epoch_end(epoch, sym, arg, aux):
        ppl.append(metric.get()[1])
    b2_rnn_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logging.disable(logging.INFO)
    try:
        mod.fit(it, num_epoch=P["epochs"], optimizer="adam",
                optimizer_params={"learning_rate": P["lr"]},
                initializer=mt.initializer.Xavier(), eval_metric=metric,
                batch_end_callback=batch_end, epoch_end_callback=epoch_end)
    finally:
        logging.disable(logging.NOTSET)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    b2 = b2_rnn_read("char_lstm", steps[0])
    it.reset()
    final = mod.score(it, mt.metric.Perplexity(ignore_label=0))[0][1]
    if not (len(ppl) == P["epochs"] and all(np.isfinite(ppl))
            and ppl[-1] < ppl[0] and np.isfinite(final)):
        raise RuntimeError("char_lstm: perplexity by epoch %s (final %s) "
                           "does not fall" % (ppl, final))
    buckets = sorted(mod._buckets)
    log("examples/char_lstm.py (its corpus, buckets %s, mx.rnn.LSTMCell(%d),"
        " BucketingModule, Adam lr %g, batch %d) on the card: %d steps in "
        "%d epochs, %.2f s; perplexity by epoch %s, final score %.3f; "
        "buckets bound %s; B2 %d launches (one a forward), no fallback  [%s]"
        % (P["buckets"], P["hidden"], P["lr"], P["batch"], steps[0],
           P["epochs"], fit_s, json.dumps([round(x, 3) for x in ppl]),
           final, buckets, b2, card))
    return {"perplexity": ppl, "final": final, "steps": steps[0],
            "fit_s": fit_s, "b2_launches": b2, "buckets": buckets}


def rnn_path(dev, card, report):
    """Phase 17: recurrent networks on the card (see the module
    docstring); returns B2's rows and its launches on each path."""
    log("phase 17: recurrent networks (the fused RNN op, gluon.rnn, mx.rnn, "
        "BucketingModule)")
    g = torch.Generator(device=dev).manual_seed(19)
    rows = {}
    b2_row(rows, "take_rows@lstm_bench", 10000, 200, (32, 35), dev, g)
    b2_row(rows, "take_rows@word_lm", 10000, 650, (32, 35), dev, g)
    b2_row(rows, "take_rows@char_lstm", len(set(CHAR_CORPUS)) + 1,
           CHAR_LSTM["embed"], (CHAR_LSTM["batch"], 25), dev, g)
    log("B2 at the recurrent paths' shapes: bitwise the plain gather")
    a = lstm_bench_path(dev, card)
    b = word_lm_path(dev, card)
    c = char_lstm_path(dev, card)
    report["rnn"] = {"lstm_bench": a, "word_lm": b, "char_lstm": c,
                     "b2": rows}
    return rows, {"lstm_bench": a["b2_launches"],
                  "word_lm": b["b2_launches"],
                  "char_lstm": c["b2_launches"]}


# ---------------------------------------------- the data pipeline (phase 18)
# bench.py's records (_make_rec(768, 256)), batch and chip K; the
# iterator as bench.py's BENCH_RECORDIO leg builds it (preprocess_threads
# = the host's cores, prefetch_buffer 4, seed 1)
# fit_batches: 5 windows, so that 4 follow the one that fills the feed;
# the long file holds as many records as the timed leg takes, so that no
# epoch ends inside it
DATA = dict(records=768, batch=128, k=30, threads=8, prefetch=4, seed=1,
            warm_batches=30, fit_batches=150, input_batches=150, det_k=2,
            h2d_batches=4)
DATA["long_records"] = DATA["fit_batches"] * DATA["batch"]
CIFAR = dict(shape=(3, 32, 32), pad=4, fill=255, mean=(125.3, 123.0, 113.9),
             std=(63.0, 62.1, 66.7))
PIXEL_BOUND = {"mean": 1.0, "p99.9": 8.0}
AUG_SOURCES = {k: "mxnet_tpu_torch/csrc/%s.cu" % k
               for k in ("image_aug", "jpeg_color")}
AUG_REPLACES = {
    "image_aug": "mxnet_tpu/io/image_record_iter.py:40 (_build_augmenter, "
                 "host numpy: no pallas_call)",
    "jpeg_color": "mxnet_tpu/io/image_record_iter.py:309 (_decode_part's "
                  "cv2.imdecode on the host: no pallas_call)"}


def load_fixture():
    """The committed JPEG fixture -> (images, block images), each a list
    of (jpeg bytes, cv2's pixels (H, W, 3) B, G, R, entry)."""
    sys.path.insert(0, os.path.join(REPO, "tests", "data", "jpeg_fixture"))
    try:
        import fixture
    finally:
        sys.path.pop(0)
    return fixture.load(), fixture.load_blocks()


REPEATS = 5


def repeat_ms(fn, dev):
    """:func:`time_ms` REPEATS times -> (the median, (min, max))."""
    t = [time_ms(fn, dev) for _ in range(REPEATS)]
    return float(np.median(t)), (min(t), max(t))


def decode_on_card(jpegs, dev):
    """``BatchDecoder.decode`` of ``jpegs`` on the card -> (h, w, 3)
    uint8 tensors of their pixels."""
    from mxnet_tpu_torch.kernels import nvjpeg
    infos = [nvjpeg.image_info(j, record=i) for i, j in enumerate(jpegs)]
    dec = nvjpeg.BatchDecoder()
    try:
        buf, boff = dec.decode(jpegs, infos, dev,
                               records=list(range(len(jpegs))))
        outs = [buf[o:o + 3 * h * w].view(h, w, 3).clone()
                for o, (_ss, h, w) in zip(boff.tolist(), infos)]
    finally:
        torch.cuda.synchronize()
        dec.close()
    return outs


def pixel_stats(diffs):
    """Per channel max, mean and 99.9th percentile of |delta| over
    arrays of shape (..., 3)."""
    a = np.concatenate([np.abs(d).reshape(-1, 3) for d in diffs])
    return {"max": a.max(0).tolist(), "mean": a.mean(0).tolist(),
            "p99.9": np.percentile(a, 99.9, axis=0).tolist()}


def check_pixels(stats, what):
    if max(stats["mean"]) > PIXEL_BOUND["mean"] \
            or max(stats["p99.9"]) > PIXEL_BOUND["p99.9"]:
        raise RuntimeError("%s: |delta| per channel %s above the bound "
                           "(mean %.1f, p99.9 %.0f levels)"
                           % (what, json.dumps(stats), PIXEL_BOUND["mean"],
                              PIXEL_BOUND["p99.9"]))


def decode_check(fx, blocks, dev, report):
    """Check 1: every fixture image decoded on the card against cv2's
    stored pixels (within the bound), and the block images, whose
    blocks are constant, bit for bit."""
    outs = decode_on_card([j for j, _, _ in fx], dev)
    diffs = [o.cpu().numpy().astype(np.int16) - px.astype(np.int16)
             for o, (_j, px, _e) in zip(outs, fx)]
    stats = pixel_stats(diffs)
    per = {e["file"]: [int(np.abs(d).max()), e["subsampling"]]
           for d, (_j, _p, e) in zip(diffs, fx)}
    log("nvJPEG + jpeg_color against cv2 on the fixture's %d JPEGs (%s): "
        "|delta| per channel B, G, R: max %s, mean %s, p99.9 %s; per image "
        "max %s" % (len(fx), ", ".join(sorted({e["subsampling"]
                                               for _j, _p, e in fx})),
                    stats["max"], ["%.4f" % m for m in stats["mean"]],
                    stats["p99.9"], json.dumps(per)))
    check_pixels(stats, "the decode")
    bouts = decode_on_card([j for j, _, _ in blocks], dev)
    exact = [bool(torch.equal(o.cpu(), torch.from_numpy(px)))
             for o, (_j, px, _e) in zip(bouts, blocks)]
    log("  block JPEGs (%s) bitwise cv2's: %s"
        % (", ".join("%s %dx%d" % (e["subsampling"], e["height"],
                                   e["width"]) for _j, _p, e in blocks),
           exact))
    if not all(exact):
        raise RuntimeError("the block JPEGs decode off cv2's bytes: %s"
                           % exact)
    report["decode"] = {"stats": stats, "per_image_max": per,
                        "blocks_bitwise": exact, "bound": PIXEL_BOUND}
    return outs


def draw_crops(rng, sizes, shape, pad=0, rand_crop=True, rand_mirror=True):
    """The JAX augmenter's draws, restated: per image (y0, x0) then the
    mirror, from one generator, for images of ``sizes`` (h, w)."""
    _, th, tw = shape
    out = []
    for h, w in sizes:
        h, w = h + 2 * pad, w + 2 * pad
        if rand_crop:
            y0, x0 = rng.randint(0, h - th + 1), rng.randint(0, w - tw + 1)
        else:
            y0, x0 = (h - th) // 2, (w - tw) // 2
        out.append((y0, x0, bool(rand_mirror and rng.rand() < 0.5)))
    return out


def aug_bound(sizes, crops, shape, pad, dtype, n_out):
    """Least time of the augment: the cropped bytes inside each image
    read once, the output written once, the descriptor table read; 4 f32
    operations an output element."""
    _, th, tw = shape
    read = 0
    for (h, w), (y0, x0, _f) in zip(sizes, crops):
        rows = max(0, min(y0 + th, h + pad) - max(y0, pad))
        cols = max(0, min(x0 + tw, w + pad) - max(x0, pad))
        read += rows * cols * 3
    out = n_out * 3 * th * tw * torch.tensor([], dtype=dtype).element_size()
    return bound_of((read + out + 48 * n_out) / HBM_BYTES_PER_S * 1e3,
                    4 * n_out * 3 * th * tw / F32_FLOPS * 1e3)


def color_bound(sizes_modes):
    """Least time of jpeg_color: the planes read once, B, G, R written."""
    from mxnet_tpu_torch.kernels import jpeg_color
    nbytes = 0
    for h, w, mode in sizes_modes:
        ch, cw = jpeg_color.chroma_shape(h, w, mode)
        nbytes += h * w * 4 + 2 * ch * cw + 80
    return bound_of(nbytes / HBM_BYTES_PER_S * 1e3,
                    12 * sum(h * w for h, w, _m in sizes_modes)
                    / F32_FLOPS * 1e3)


def aug_kernel_check(imgs, dev, report):
    """Check 2: the augment kernel against its plain version on the same
    decoded buffers, bitwise: the ImageNet recipe (rand_crop, rand_mirror,
    224 x 224) at batch 128 in f32, bf16 and f16, and the CIFAR recipe
    (pad 4, fill 255, mean/std, 32 x 32); timed at the main path's shape
    beside the plain version and its bound. Then jpeg_color against its
    plain version on random planes at the fixture's shapes in 4:4:4 and
    4:2:0, bitwise, timed over a batch of 128."""
    from mxnet_tpu_torch.kernels import image_aug, jpeg_color
    B = DATA["batch"]
    srcs = [imgs[i % len(imgs)] for i in range(B)]
    sizes = [tuple(s.shape[:2]) for s in srcs]
    rows = {}
    for name, shape, dt, kw in (
            ("imagenet/float32", (3, 224, 224), torch.float32, {}),
            ("imagenet/bfloat16", (3, 224, 224), torch.bfloat16, {}),
            ("imagenet/float16", (3, 224, 224), torch.float16, {}),
            ("cifar/float32", CIFAR["shape"], torch.float32,
             dict(pad=CIFAR["pad"], fill=CIFAR["fill"], mean=CIFAR["mean"],
                  std=CIFAR["std"]))):
        crops = draw_crops(np.random.RandomState(len(rows)), sizes, shape,
                           pad=kw.get("pad", 0))
        out = torch.empty((B,) + shape, dtype=dt, device=dev)
        image_aug.augment(srcs, crops, out, **kw)
        cpu = torch.empty((B,) + shape, dtype=dt)
        image_aug.augment([s.cpu() for s in srcs], crops, cpu, **kw)
        iv = torch.int32 if dt == torch.float32 else torch.int16
        if not torch.equal(out.cpu().view(iv), cpu.view(iv)):
            raise RuntimeError("image_aug %s: the kernel is not bitwise its "
                               "plain version" % name)
        if name == "imagenet/float32":
            full = dict(pad=0, fill=255, mean=(0.0,) * 3, std=(1.0,) * 3,
                        scale=1.0, normalize=False)
            # the kernel timed from a descriptor table already on the
            # card; the wrapper (the table pinned and copied, then the
            # launch, as the pipeline calls it) beside it
            table = np.array([(im.data_ptr(), im.shape[0], im.shape[1], y0,
                               x0, int(f)) for im, (y0, x0, f)
                              in zip(srcs, crops)], np.int64)
            dev_table = torch.from_numpy(table).to(dev)
            norm = image_aug._norm_args(full["mean"], full["std"],
                                        full["scale"], full["normalize"])
            ms, spread = repeat_ms(lambda: image_aug._launch(
                dev_table, out, 0, 255, *norm), dev)
            wrapper, wspread = repeat_ms(
                lambda: image_aug.launch_table(table, out), dev)
            plain = time_ms(lambda: image_aug._plain_augment(
                srcs, crops, out, **full), dev, iters=3, warmup=1)
            bound, by = aug_bound(sizes, crops, shape, 0, dt, B)
            rows["image_aug"] = {"shape": [B] + list(shape), "ms": ms,
                                 "ms_spread": spread, "wrapper_ms": wrapper,
                                 "wrapper_ms_spread": wspread,
                                 "plain_ms": plain, "bound_ms": bound,
                                 "bound_by": by, "library_ms": None}
    # jpeg_color on random planes, the fixture's image shapes repeated
    rng = np.random.RandomState(7)
    items = []
    for i in range(B):
        h, w = sizes[i]
        mode = 3 if i % 2 == 0 else 1
        ch, cw = jpeg_color.chroma_shape(h, w, mode)
        planes = [torch.from_numpy(rng.randint(0, 256, s).astype(np.uint8))
                  .to(dev) for s in ((h, w), (ch, cw), (ch, cw))]
        items.append(planes + [torch.empty((h, w, 3), dtype=torch.uint8,
                                           device=dev), mode])
    jpeg_color.ycc_to_bgr([tuple(t) for t in items])
    for y, cb, cr, out, mode in items:
        want = torch.empty((out.shape[0], out.shape[1], 3),
                           dtype=torch.uint8)
        jpeg_color._plain_image(y.cpu(), cb.cpu(), cr.cpu(), want, mode)
        if not torch.equal(out.cpu(), want):
            raise RuntimeError("jpeg_color: the kernel is not bitwise its "
                               "plain version (mode %d)" % mode)
    cols = list(zip(*items))
    table = jpeg_color.descriptors(
        *[[t.data_ptr() for t in c] for c in cols[:4]],
        [y.shape[0] for y in cols[0]], [y.shape[1] for y in cols[0]],
        cols[4])
    dev_table = torch.from_numpy(table).to(dev)
    maxpix = max(int(t[0].numel()) for t in items)
    ms, spread = repeat_ms(lambda: jpeg_color._launch(
        dev_table, len(table), maxpix, dev), dev)
    wrapper, wspread = repeat_ms(
        lambda: jpeg_color._launch_table(table, dev), dev)
    plain = time_ms(lambda: [jpeg_color._plain_image(*t) for t in items],
                    dev, iters=3, warmup=1)
    bound, by = color_bound([(t[0].shape[0], t[0].shape[1], t[4])
                             for t in items])
    rows["jpeg_color"] = {"shape": "%d images, 4:2:0 and 4:4:4, %dx%d mean"
                          % (B, np.mean([s[0] for s in sizes]),
                             np.mean([s[1] for s in sizes])),
                          "ms": ms, "ms_spread": spread,
                          "wrapper_ms": wrapper, "wrapper_ms_spread": wspread,
                          "plain_ms": plain, "bound_ms": bound,
                          "bound_by": by, "library_ms": None}
    for k, r in rows.items():
        log("%s kernel, bitwise its plain version; at %s: %.4f ms from a "
            "table on the card (%.4f-%.4f over %d timings), %.4f ms through "
            "the wrapper with its table upload (%.4f-%.4f), plain %.4f ms, "
            "bound %.4f ms (%s, %.0f%%)  [%s]"
            % (k, r["shape"], r["ms"], r["ms_spread"][0], r["ms_spread"][1],
               REPEATS, r["wrapper_ms"], r["wrapper_ms_spread"][0],
               r["wrapper_ms_spread"][1], r["plain_ms"], r["bound_ms"],
               r["bound_by"], 100 * r["bound_ms"] / r["ms"], card_line()))
    report["aug_kernels"] = rows
    return rows


def decode_timing(fx, dev, report):
    """nvJPEG per batch of 128 record images (CUDA events around one
    ``BatchDecoder.decode``: the batched nvJPEG call and the jpeg_color
    launch), jpeg_color's share,
    and cv2's host decode of the same JPEGs beside it where cv2 is
    installed (a yardstick; the port never calls it)."""
    from mxnet_tpu_torch.kernels import jpeg_color, nvjpeg
    B = DATA["batch"]
    jpegs = [fx[i % len(fx)][0] for i in range(B)]
    infos = [nvjpeg.image_info(j) for j in jpegs]
    dec = nvjpeg.BatchDecoder()
    times = []
    for _ in range(5):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        e0.record()
        dec.decode(jpegs, infos, dev)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    dec.close()
    dec_ms = float(np.median(times[1:]))
    nbytes = sum(len(j) for j in jpegs)
    planes = sum(h * w * (3 if ss == "444" else 1.5) for ss, h, w in infos)
    bgr = sum(h * w * 3 for _ss, h, w in infos)
    bound, by = bound_of((nbytes + planes + bgr) / HBM_BYTES_PER_S * 1e3, 0.0)
    cv2_ms = None
    try:
        import cv2
        t0 = time.perf_counter()
        for j in jpegs:
            cv2.imdecode(np.frombuffer(j, np.uint8), cv2.IMREAD_COLOR)
        cv2_ms = (time.perf_counter() - t0) * 1e3
    except ImportError:
        pass
    color_ms = report["aug_kernels"]["jpeg_color"]["ms"]
    row = {"shape": "%d JPEGs, %.1f KB mean" % (B, nbytes / B / 1e3),
           "ms": dec_ms, "nvjpeg_ms": dec_ms - color_ms,
           "jpeg_color_ms": color_ms, "plain_ms": cv2_ms,
           "bound_ms": bound, "bound_by": by, "jpeg_bytes": nbytes}
    log("decode of %d record JPEGs, one batched call: %.3f ms (nvJPEG %.3f + "
        "jpeg_color %.4f); cv2.imdecode on the host %s; bound %.4f ms "
        "(%s)  [%s]" % (B, dec_ms, dec_ms - color_ms, color_ms,
                        "%.3f ms" % cv2_ms if cv2_ms is not None
                        else "not measured (no cv2)", bound, by,
                        card_line()))
    report["decode_timing"] = row
    return row


def write_records(fx, path, n=DATA["records"]):
    """bench.py's record count (or ``n``) from the fixture: record i
    holds fixture image i % 16's JPEG bytes and label i % 1000."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    w = mt.recordio.MXIndexedRecordIO(os.path.splitext(path)[0] + ".idx",
                                      path, "w")
    for i in range(n):
        w.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(i % 1000), i, 0),
            fx[i % len(fx)][0]))
    w.close()
    return path


def record_iter(path, **kw):
    """The card iterator as bench.py's BENCH_RECORDIO leg builds it."""
    args = dict(rand_crop=True, rand_mirror=True, shuffle=True,
                preprocess_threads=DATA["threads"],
                prefetch_buffer=DATA["prefetch"], seed=DATA["seed"],
                ctx=mt.gpu(0))
    args.update(kw)
    return mt.io.ImageRecordIter(path, (3, 224, 224), DATA["batch"], **args)


def epoch_check(path, fx, report):
    """Check 3: one epoch of ImageRecordIter on the card against the
    batches the plain augment builds from the fixture's cv2 pixels in the
    same order with the same draws (restated here from the JAX
    package's rule): labels equal, pixels within check 1's bound over the
    epoch and in every image (a wrong draw moves an image's mean by tens
    of levels)."""
    from mxnet_tpu_torch.kernels import image_aug
    B, P, S = DATA["batch"], DATA["threads"], DATA["seed"]
    it = record_iter(path)
    got = [(b.data[0].data.cpu(), b.label[0].data.cpu()) for b in it]
    it.close()
    order = np.arange(DATA["records"])
    np.random.RandomState(S).shuffle(order)
    diffs, worst = [], 0.0
    if len(got) != DATA["records"] // B:
        raise RuntimeError("an epoch of %d batches, expected %d"
                           % (len(got), DATA["records"] // B))
    for b, (data, label) in enumerate(got):
        idxs = order[b * B:(b + 1) * B]
        crops = []
        for p in range(P):
            rng = np.random.RandomState(S + b * 1009 + p)
            part = idxs[p * B // P:(p + 1) * B // P]
            crops += draw_crops(rng, [fx[i % len(fx)][1].shape[:2]
                                      for i in part], (3, 224, 224))
        want = torch.empty((B, 3, 224, 224))
        image_aug.augment([torch.from_numpy(fx[i % len(fx)][1])
                           for i in idxs], crops, want)
        if not torch.equal(label, torch.from_numpy(
                (idxs % 1000).astype(np.float32))):
            raise RuntimeError("batch %d: labels differ" % b)
        d = (data - want).numpy().transpose(0, 2, 3, 1)
        diffs.append(d)
        worst = max(worst, float(np.abs(d).mean(axis=(1, 2, 3)).max()))
    stats = pixel_stats(diffs)
    log("an epoch of ImageRecordIter on the card (%d batches of %d, %d "
        "threads) against the plain augment of cv2's pixels, same order "
        "and draws: labels equal; |delta| max %s, mean %s, p99.9 %s; worst "
        "image mean %.4f" % (len(got), B, P, stats["max"],
                             ["%.4f" % m for m in stats["mean"]],
                             stats["p99.9"], worst))
    check_pixels(stats, "the card iterator")
    if worst > PIXEL_BOUND["mean"]:
        raise RuntimeError("an image's mean |delta| %.3f: its draw differs"
                           % worst)
    report["epoch_check"] = {"stats": stats, "worst_image_mean": worst}


def records_module(sym, p0, aux0, dev):
    mod = mt.mod.Module(sym, context=dev)
    mod.bind([("data", (DATA["batch"], 3, 224, 224))],
             [("softmax_label", (DATA["batch"],))])
    mod.init_params(arg_params=p0, aux_params=aux0)
    mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                       optimizer_params=dict(RESNET_SGD,
                                             multi_precision=True))
    return mod


def fit_leg(mod, it, batches):
    """A timed ``fit`` over ``batches`` batches of ``it`` at DATA's K (a
    new StagedKFeed, so the first window's wait is the feed filling) ->
    its rate over all windows and after the first window's data came,
    and the data wait of each window from ``fit``'s accumulator."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records_fit(mod, it, batches, DATA["k"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stall = list(mod.data_stats["input_stall_ms"])
    n = batches * DATA["batch"]
    return {"img_per_s": n / wall, "wall_s": wall, "stall_ms": stall,
            "fill_ms": stall[0],
            "steady_wait_ms": float(np.mean(stall[1:])),
            "steady_img_per_s": n / (wall - stall[0] / 1e3)}


def input_leg(mod, it, batches):
    """Decode, augment and stage ``batches`` batches of ``it`` through a
    StagedKFeed, no training -> images/s."""
    from mxnet_tpu_torch.data import StagedKFeed
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed = StagedKFeed(iter(mt.io.ResizeIter(it, batches,
                                             reset_internal=False)),
                       DATA["k"], mod._stage_group, depth=2,
                       stream=mod._staging_stream())
    try:
        while True:
            win = feed.next_window()
            win.staged["ready"].synchronize()
            del win
    except StopIteration:
        pass
    feed.close()
    return batches * DATA["batch"] / (time.perf_counter() - t0)


def records_fit(mod, path_or_iter, batches, k):
    """``fit`` over ``batches`` batches of the card iterator (an epoch of
    a ResizeIter around it) -> the iterator it made, if any."""
    it = record_iter(path_or_iter) if isinstance(path_or_iter, str) \
        else path_or_iter
    mod.fit(mt.io.ResizeIter(it, batches, reset_internal=False),
            num_epoch=1, eval_metric=None, kvstore="tpu_sync",
            steps_per_dispatch=k)
    return it


def staged_check(sym, p0, aux0, path, dev, report):
    """Check 4: fit through the records, staged against unstaged, K = 2
    for 2 windows, cuDNN held to deterministic algorithms in both runs:
    every parameter and moving statistic bitwise equal."""
    K = DATA["det_k"]
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    states = {}
    try:
        for staged in (True, False):
            mod = records_module(sym, p0, aux0, dev)
            with mt.config.override(data_staged_feed=staged):
                it = records_fit(mod, path, 2 * K, K)
            it.close()
            if mod.data_stats["staged"] != staged \
                    or mod._fused.captures != 1:
                raise RuntimeError("staged=%s: the fit ran %s, %d captures"
                                   % (staged, mod.data_stats,
                                      mod._fused.captures))
            args, aux = mod.get_params()
            states[staged] = {k: v.detach().cpu().clone()
                              for k, v in {**args, **aux}.items()}
            mod._fused.release_graphs()
            del mod
            released(dev)
    finally:
        torch.backends.cudnn.deterministic = det
    diff = [k for k in states[True]
            if not torch.equal(states[True][k], states[False][k])]
    moved = not torch.equal(states[True]["fc1_weight"], p0["fc1_weight"])
    log("staged against unstaged fit on the card (ResNet-50 bf16, batch %d, "
        "K %d, 2 windows through the records): %d of %d tensors differ; "
        "weights moved %s" % (DATA["batch"], K, len(diff), len(states[True]),
                              moved))
    if diff or not moved:
        raise RuntimeError("staged and unstaged fits part: %s" % diff[:5])
    report["staged_check"] = {"tensors": len(states[True]), "differ": diff}


def h2d_profile(path, dev):
    """Bytes copied host to device per batch made by the card iterator,
    from torch.profiler's memcpy records (nvJPEG's own copies included),
    over DATA["h2d_batches"] batches -> (bytes a batch or None, JPEG
    bytes a batch)."""
    from torch.profiler import ProfilerActivity, profile
    it = record_iter(path)
    next(it)
    torch.cuda.synchronize()
    trace = os.path.join(REPO, "build", "chip_smoke", "h2d_trace.json")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(DATA["h2d_batches"]):
            next(it)
        torch.cuda.synchronize()
    it.close()
    prof.export_chrome_trace(trace)
    with open(trace) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(trace)
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"
              and "HtoD" in e.get("name", "")]
    n = sum(int(e.get("args", {}).get("bytes", 0)) for e in copies)
    return (n / DATA["h2d_batches"] if copies and n else None), len(copies)


def records_path(dev, card, report):
    """Phase 18: ResNet-50 v1 trained from .rec records (see the module
    docstring) -> (B1 launches by form through the wrapper, the augment
    kernels' rows, their launches)."""
    from mxnet_tpu_torch.kernels import image_aug, jpeg_color, nvjpeg
    log("phase 18: the data pipeline (records -> ImageRecordIter on the "
        "card -> StagedKFeed -> Module.fit, ResNet-50 bf16, batch %d, K %d)"
        % (DATA["batch"], DATA["k"]))
    fx, blocks = load_fixture()
    imgs = decode_check(fx, blocks, dev, report)
    rows = aug_kernel_check(imgs, dev, report)
    del imgs
    decode_timing(fx, dev, report)
    path = write_records(fx, os.path.join(REPO, "build", "chip_smoke",
                                          "records.rec"))
    jpeg_per_batch = DATA["batch"] * np.mean([len(j) for j, _, _ in fx])
    epoch_check(path, fx, report)
    sym = resnet50()
    p0, aux0 = resnet_init(sym, dev)
    staged_check(sym, p0, aux0, path, dev, report)
    # -- the main path: counts zeroed just before, read just after
    K, B = DATA["k"], DATA["batch"]
    mod = records_module(sym, p0, aux0, dev)
    fused = mod._fused
    rit = record_iter(path)
    torch.cuda.reset_peak_memory_stats(dev)
    tier.reset_stats()
    for m in (bn_act, image_aug, jpeg_color):
        m.reset_launches()
    nvjpeg.reset_decodes()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    records_fit(mod, rit, DATA["warm_batches"], K)
    alloc0 = nvjpeg.allocations()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    leg = fit_leg(mod, rit, DATA["fit_batches"])
    alloc = [b - a for a, b in zip(alloc0, nvjpeg.allocations())]
    b1 = dict(bn_act.launches_by_kernel)
    counts = {"image_aug": image_aug.launches,
              "jpeg_color": jpeg_color.launches,
              "nvjpeg_decodes": nvjpeg.decodes}
    stats = tier.stats()
    mem = torch.cuda.max_memory_allocated(dev)
    made = DATA["warm_batches"] + DATA["fit_batches"]
    if fused.captures != 1 or fused.replays != made - 2 \
            or not mod.data_stats["staged"]:
        raise RuntimeError("records fit: %d captures, %d replays, staged "
                           "%s; expected 1, %d, True"
                           % (fused.captures, fused.replays,
                              mod.data_stats["staged"], made - 2))
    if b1 != {"bn_act": 33 * 3, "bn_act_res": 16 * 3} or stats["fallback"]:
        raise RuntimeError("B1 launches through the wrapper (2 warm-up "
                           "steps and the capture): %s, fallback %s"
                           % (b1, stats["fallback"]))
    if counts["image_aug"] < made or counts["jpeg_color"] < made \
            or counts["nvjpeg_decodes"] < made * B:
        raise RuntimeError("the records fit made %d batches, but the "
                           "kernels ran %s" % (made, counts))
    # -- the replayed step on one batch already on the card, same module
    X, Y = image_batch(B)
    t0 = time.perf_counter()
    grouped_fit(mod, OneBatchIter(X, Y, DATA["fit_batches"], dev), K)
    torch.cuda.synchronize()
    compute_s = time.perf_counter() - t0
    compute_rate = DATA["fit_batches"] * B / compute_s
    window_ms = compute_s / DATA["fit_batches"] * K * 1e3
    if fused.captures != 1:
        raise RuntimeError("the replayed step recaptured")
    # -- input only: decode, augment and stage, no training
    input_rate = input_leg(mod, rit, DATA["input_batches"])
    overlap = leg["img_per_s"] / min(input_rate, compute_rate)
    # -- the fit leg's busy share, one profiled window
    cen = graph_census(lambda: records_fit(mod, rit, K, K))
    rit.close()
    h2d, n_copies = h2d_profile(path, dev)
    # -- the same legs over a file as long as the timed leg: no epoch
    #    ends (each end restarts the iterator's feeder) inside them
    lpath = write_records(fx, os.path.join(REPO, "build", "chip_smoke",
                                           "records_long.rec"),
                          DATA["long_records"])
    lit = record_iter(lpath)
    long_input = input_leg(mod, lit, DATA["input_batches"])
    lit.close()
    lit = record_iter(lpath)
    long_leg = fit_leg(mod, lit, DATA["fit_batches"])
    lit.close()
    os.remove(lpath)
    os.remove(os.path.splitext(lpath)[0] + ".idx")
    # a window after the first, beyond the replayed step's: the epoch
    # ends (the 768-record window against the long file's) and the input
    # side beside the step (the long file's window against the replayed
    # one); the feed's fill, once a fit call, is window 1's wait. The
    # host's data wait overlaps the card's work on the window before, so
    # it stands beside these and is not summed with them
    per = K / DATA["fit_batches"]
    steady_ms = (leg["wall_s"] * 1e3 - leg["fill_ms"]) * per
    long_ms = (long_leg["wall_s"] * 1e3 - long_leg["fill_ms"]) * per
    split = {"fill_ms": leg["fill_ms"], "window_ms": steady_ms,
             "long_window_ms": long_ms, "replayed_window_ms": window_ms,
             "epoch_ends_ms": steady_ms - long_ms,
             "beside_step_ms": long_ms - window_ms,
             "wait_ms": leg["steady_wait_ms"],
             "long_wait_ms": long_leg["steady_wait_ms"]}
    log("records fit (%d records, an epoch every %d batches): %.1f images/s "
        "over %d windows of K %d (wall %.2f s), %.1f after window 1's data "
        "came; the replayed one-batch step %.1f images/s (%.2f ms a "
        "window) in this run; input only (decode, augment, stage) %.1f "
        "images/s; overlap %.3f (achieved / min(input, compute)); data "
        "wait per window %s ms; first fit call (capture) %.1f ms; busy "
        "%.1f%% (profiled window, %.2f of %.2f ms); peak memory %.2f GB  "
        "[%s]" % (DATA["records"], DATA["records"] // B, leg["img_per_s"],
                  len(leg["stall_ms"]), K, leg["wall_s"],
                  leg["steady_img_per_s"], compute_rate, window_ms,
                  input_rate, overlap, ["%.2f" % s for s in leg["stall_ms"]],
                  first_ms, 100 * cen["busy_share"], cen["device_ms"],
                  cen["wall_ms"], mem / 1e9, card))
    log("  the same over %d records (no epoch end inside): fit %.1f images/s"
        ", %.1f after window 1; input only %.1f images/s; data wait per "
        "window %s ms" % (DATA["long_records"], long_leg["img_per_s"],
                          long_leg["steady_img_per_s"], long_input,
                          ["%.2f" % s for s in long_leg["stall_ms"]]))
    log("  a window after the first takes %.1f ms against the replayed "
        "step's %.1f: epoch ends %.1f ms (against the long file's %.1f), "
        "the input side beside the step %.1f ms; the feed's fill %.1f ms "
        "once a fit call (window 1's wait); the host's data wait after "
        "window 1 %.1f ms a window (long file %.1f), overlapping the "
        "card's work on the window before  [%s]"
        % (steady_ms, window_ms, split["epoch_ends_ms"], long_ms,
           split["beside_step_ms"], split["fill_ms"], split["wait_ms"],
           split["long_wait_ms"], card))
    log("  host to device per batch: %s by torch.profiler (%d copies over "
        "%d batches); the JPEG bytes alone %.0f; the f32 batch the JAX "
        "package copies %d; launches in the main path %s, B1 %s; nvJPEG's "
        "allocator over the timed fit (device allocations, frees, pinned "
        "made, pinned reused) %s"
        % ("%.0f bytes" % h2d if h2d is not None else "not measured",
           n_copies, DATA["h2d_batches"], jpeg_per_batch,
           B * 3 * 224 * 224 * 4, json.dumps(counts), json.dumps(b1),
           alloc))
    report["records"] = {
        "fit_img_per_s": leg["img_per_s"],
        "fit_steady_img_per_s": leg["steady_img_per_s"],
        "compute_img_per_s": compute_rate, "input_img_per_s": input_rate,
        "overlap": overlap, "stall_ms": leg["stall_ms"],
        "long": {"records": DATA["long_records"], "fit": long_leg,
                 "input_img_per_s": long_input},
        "wait_split": split, "first_fit_ms": first_ms,
        "busy_share": cen["busy_share"], "census": cen,
        "peak_memory_bytes": mem, "h2d_bytes_per_batch": h2d,
        "jpeg_bytes_per_batch": jpeg_per_batch, "launches": counts,
        "b1_launches": b1, "nvjpeg_allocations": alloc}
    fused.release_graphs()
    del mod, fused
    released(dev)
    return b1, rows, counts



# ------------------------------- kvstore, checkpoints, the loop (phase 19)
KV = dict(values=262144, reps=20, threshold=0.5, list_reps=5)
LOOP = dict(batches=30, epochs=2, k=30, disp=20, resume_every=30,
            resume_steps=60, total_steps=120, predict_batches=2,
            monitor_steps=3, gluon_batch=32, gluon_steps=3)
IMAGENET_SGD = {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4,
                "multi_precision": True}
MONITOR_PATTERN = "fc1_weight|bn0_gamma|softmax_output"


def np_quantize(acc, thr):
    """The JAX package's ``_compress`` in numpy f32: acc to {-t, 0, t}."""
    t = np.float32(thr)
    return np.where(acc >= t, t, np.where(acc <= -t, -t,
                                          np.float32(0))).astype(np.float32)


def np_pack_2bit(g, res, thr):
    """The JAX package's ``_pack_2bit`` in numpy -> (packed, residual)."""
    acc = g + res
    t = np.float32(thr)
    plus, minus = acc >= t, acc <= -t
    codes = (plus.astype(np.uint8) + 2 * minus.astype(np.uint8)).ravel()
    codes = np.concatenate([codes, np.zeros((-codes.size) % 4, np.uint8)])
    c = codes.reshape(-1, 4)
    packed = (c[:, 0] | (c[:, 1] << 2) | (c[:, 2] << 4)
              | (c[:, 3] << 6)).astype(np.uint8)
    return packed, acc - np_quantize(acc, thr)


def kv_case(dev, kind, two, compress, card):
    """One case of ``tools/bandwidth.py``'s ``measure`` on the card: 1 MB
    of f32 from RandomState(0), one warm-up, 20 synchronized push + pull
    repetitions -> the row. Checks, each raising: the pull bitwise the
    pushed value (or sum); with 2-bit, 3 pushes from a fresh store with
    the residual carried bitwise a numpy copy of ``_compress``."""
    n, reps, thr = KV["values"], KV["reps"], KV["threshold"]
    rng = np.random.RandomState(0)
    val = rng.randn(n).astype(np.float32)
    grads = [rng.randn(n).astype(np.float32) for _ in range(2 if two else 1)]
    g_dev = [torch.from_numpy(g).to(dev) for g in grads]
    push = g_dev if two else g_dev[0]

    def store():
        kv = mt.kv.create(kind)
        if compress:
            kv.set_gradient_compression({"type": "2bit", "threshold": thr})
        kv.init("k", torch.from_numpy(val).to(dev))
        return kv

    # the check, from a fresh store
    kv = store()
    out = torch.zeros(n, device=dev)
    total = grads[0] + grads[1] if two else grads[0].copy()
    res = np.zeros(n, np.float32)
    for i in range(3 if compress else 1):
        kv.push("k", push)
        kv.pull("k", out=out, ignore_sparse=False)
        got = out.cpu().numpy()
        if compress:
            acc = total + res
            want = np_quantize(acc, thr)
            res = acc - want
            if not np.array_equal(kv._residuals["k"].cpu().numpy(), res):
                raise RuntimeError("kvstore %s 2bit: residual %d not numpy's"
                                   % (kind, i))
        else:
            want = total
        if not np.array_equal(got, want):
            raise RuntimeError("kvstore %s (%s, %s): pull %d not bitwise the "
                               "pushed value" % (kind, "two" if two else
                                                 "one", compress, i))
        if kv._store["k"].device != dev:
            raise RuntimeError("kvstore: the stored value left the card")
    # the timing, as measure() runs it
    kv = store()

    def once():
        kv.push("k", push)
        kv.pull("k", out=out, ignore_sparse=False)
        torch.cuda.synchronize()

    once()
    t0 = time.perf_counter()
    for _ in range(reps):
        once()
    dt = (time.perf_counter() - t0) / reps
    size = n * 4
    ndev = len(grads)
    wire = kv._last_wire_bytes
    moved = (wire or size) * ndev + size          # measure()'s formula
    # read each pushed value once, write the stored value and the pulled
    # copy once, and with 2-bit read and write the residual once more
    bound_bytes = size * (ndev + 2) + (2 * size if compress else 0)
    row = {"kind": kind, "values": ndev,
           "compression": "2bit" if compress else "none",
           "us": dt * 1e6, "gb_per_s": moved / dt / 1e9,
           "gbit_per_s": moved * 8 / dt / 1e9,
           "bound_us": bound_bytes / HBM_BYTES_PER_S * 1e6,
           "wire_bytes": wire}
    log("  kvstore %-6s %s value%s, compression %-4s: %.1f us a push + pull"
        " (%.2f GB/s, %.2f Gbit/s by measure's formula); bound %.2f us "
        "(%d bytes over 3.35 TB/s); _last_wire_bytes %s  [%s]"
        % (kind, ndev, "s" if ndev > 1 else " ", row["compression"],
           row["us"], row["gb_per_s"], row["gbit_per_s"], row["bound_us"],
           bound_bytes, wire, card))
    return row


def kv_pack_check(dev):
    """``_pack_2bit`` on the card bitwise numpy's, ``_dequantize_2bit``
    giving back the quantized values, on the card and on the host."""
    from mxnet_tpu_torch import kvstore as tkv
    rng = np.random.RandomState(1)
    for n in (KV["values"], 1001):
        g, res = (rng.randn(n).astype(np.float32) for _ in range(2))
        packed, new_res = tkv._pack_2bit(torch.from_numpy(g).to(dev),
                                         torch.from_numpy(res).to(dev),
                                         KV["threshold"])
        want_p, want_r = np_pack_2bit(g, res, KV["threshold"])
        q = np_quantize(g + res, KV["threshold"])
        back = tkv._dequantize_2bit(packed, (n,), KV["threshold"])
        if not (np.array_equal(packed.cpu().numpy(), want_p)
                and np.array_equal(new_res.cpu().numpy(), want_r)
                and np.array_equal(back.cpu().numpy(), q)
                and np.array_equal(tkv._dequantize_2bit(
                    want_p, (n,), KV["threshold"]), q)):
            raise RuntimeError("_pack_2bit/_dequantize_2bit on the card are "
                               "not numpy's at %d values" % n)
    return packed.numel()


def kv_resnet_lists(dev, card, sym, p0):
    """Every ResNet-50 parameter as a list of keys: one push + pull
    through ``local`` (the pull bitwise the push) and through
    ``dist_sync`` in one process with an SGD momentum updater (the
    stored weights bitwise the Module's Updater on the same gradients) ->
    rows."""
    names = sorted(p0)
    gen = torch.Generator(device=dev).manual_seed(0)
    weights = [p0[k].to(dev) for k in names]
    grads = [torch.randn(w.shape, generator=gen, device=dev)
             for w in weights]
    nbytes = sum(w.numel() * 4 for w in weights)
    rows = {}
    for kind in ("local", "dist_sync"):
        kv = mt.kv.create(kind)
        if kind == "dist_sync":
            kv.set_optimizer(mt.optimizer.create("sgd", **RESNET_SGD))
        kv.init(names, weights)
        outs = [torch.empty_like(w) for w in weights]
        kv.push(names, grads)
        kv.pull(names, out=outs)
        if kind == "local":
            bad = [n for n, o, g in zip(names, outs, grads)
                   if not torch.equal(o, g)]
        else:
            upd = mt.optimizer.get_updater(
                mt.optimizer.create("sgd", **RESNET_SGD))
            ref = [w.clone() for w in weights]
            for n, g, w in zip(names, grads, ref):
                upd(n, g, w)
            bad = [n for n, o, w in zip(names, outs, ref)
                   if not torch.equal(o, w)]
        if bad:
            raise RuntimeError("kvstore %s over ResNet-50's %d arrays: %s "
                               "not bitwise" % (kind, len(names), bad[:3]))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(KV["list_reps"]):
            kv.push(names, grads)
            kv.pull(names, out=outs)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / KV["list_reps"] * 1e6
        # push: read the gradient, write the store (and for the update,
        # read and write weight and momentum); pull: read, write
        bound = nbytes * (4 if kind == "local" else 7)
        rows[kind] = {"arrays": len(names), "bytes": nbytes, "us": us,
                      "gb_per_s": 2 * nbytes / (us / 1e6) / 1e9,
                      "bound_us": bound / HBM_BYTES_PER_S * 1e6}
        log("  kvstore %s, ResNet-50's %d parameter arrays (%.1f MB) as one "
            "list of keys%s: %.1f us a push + pull, bound %.1f us; bitwise "
            "%s  [%s]" % (kind, len(names), nbytes / 1e6,
                          " with an SGD momentum updater"
                          if kind == "dist_sync" else "", us,
                          rows[kind]["bound_us"],
                          "the pushed values" if kind == "local"
                          else "the Module's Updater", card))
    return rows


class LineCatcher(logging.Handler):
    """The root logger's INFO lines (the callbacks' own), kept."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def card_labels(batch):
    lab = batch.label[0]
    return getattr(lab, "_data", lab)


def imagenet_fit(sym, path, dev, kvstore, k, p0, aux0, prefix,
                 begin_epoch=0, num_epoch=LOOP["epochs"]):
    """``examples/train_imagenet.py``'s ``fit`` call through ``mt``: a
    Module on gpu(0), ``Speedometer(128, 20)``, ``do_checkpoint(prefix)``
    (timed), SGD lr 0.05 momentum 0.9 wd 1e-4 in bf16 over f32 masters,
    metric acc, over ``ResizeIter(ImageRecordIter, 30)`` epochs. Each
    step's loss is computed on the card (no wait) -> (module, result)."""
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    it = record_iter(path)
    saves, losses, params = [], [], {}
    ckpt = mt.callback.do_checkpoint(prefix)

    def timed_ckpt(epoch, s, arg, aux):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt(epoch, s, arg, aux)
        saves.append((time.perf_counter() - t0) * 1e3)
        params[epoch + 1] = {k_: v.detach().cpu().clone()
                             for k_, v in list(arg.items())
                             + list(aux.items())}

    def loss_cb(param):
        if k == 1:
            out = mod.get_outputs()[0].float()
            lab = card_labels(param.locals["data_batch"]).long()
            losses.append(-out.gather(1, lab.unsqueeze(1)).clamp_min(
                1e-30).log().mean())

    catcher = LineCatcher()
    logging.getLogger().addHandler(catcher)
    level = logging.getLogger().level
    logging.getLogger().setLevel(logging.INFO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        mod.fit(mt.io.ResizeIter(it, LOOP["batches"], reset_internal=False),
                num_epoch=num_epoch, eval_metric="acc", kvstore=kvstore,
                optimizer="sgd", optimizer_params=dict(IMAGENET_SGD),
                arg_params=p0, aux_params=aux0, begin_epoch=begin_epoch,
                batch_end_callback=[mt.callback.Speedometer(
                    DATA["batch"], LOOP["disp"]), loss_cb],
                epoch_end_callback=[timed_ckpt],
                steps_per_dispatch=None if k == 1 else k)
        torch.cuda.synchronize()
    finally:
        logging.getLogger().removeHandler(catcher)
        logging.getLogger().setLevel(level)
        it.close()
    wall = time.perf_counter() - t0
    steps = LOOP["batches"] * (num_epoch - begin_epoch)
    n = steps * DATA["batch"]
    return mod, {"img_per_s": n / wall,
                 "img_per_s_without_saves": n / (wall - sum(saves) / 1e3),
                 "wall_s": wall, "save_ms": saves,
                 "losses": [float(x) for x in losses],
                 "lines": [ln for ln in catcher.lines if "Speed" in ln
                           or "Epoch[" in ln],
                 "params": params, "steps": steps}


def imagenet_loop(sym, path, dev, card, p0, aux0, report):
    """Part b: train_imagenet.py's own loop, tpu_sync and a ``KVStore``
    object, per step (the automatic K with a callback) and K = 30; then
    the ``--load-epoch`` restart. -> B1 launches by form at K = 1."""
    out_dir = os.path.join(REPO, "build", "chip_smoke", "imagenet")
    os.makedirs(out_dir, exist_ok=True)
    runs, b1_k1 = {}, {"bn_act": 0, "bn_act_res": 0}
    for kv_name in ("tpu_sync", "local"):
        for k in (1, LOOP["k"]):
            kvstore = kv_name if kv_name == "tpu_sync" \
                else mt.kv.create(kv_name)
            prefix = os.path.join(out_dir, "%s-k%d" % (kv_name, k))
            tier.reset_stats()
            bn_act.reset_launches()
            mod, r = imagenet_fit(sym, path, dev, kvstore, k, p0, aux0,
                                  prefix)
            b1 = dict(bn_act.launches_by_kernel)
            fallback = tier.stats()["fallback"]
            fused = mod._fused
            name = "%s/K%d" % (kv_name, k)
            if fused is None or fused.compute_dtype != torch.bfloat16 \
                    or fallback:
                raise RuntimeError("imagenet loop %s: fused %s, fallback %s"
                                   % (name, fused, fallback))
            if k == 1:
                want = {"bn_act": 33 * r["steps"],
                        "bn_act_res": 16 * r["steps"]}
                if b1 != want:
                    raise RuntimeError("imagenet loop %s: B1 launches %s, "
                                       "want 49 a forward %s"
                                       % (name, b1, want))
                for f in b1:
                    b1_k1[f] += b1[f]
                if not falling(r["losses"]):
                    raise RuntimeError("imagenet loop %s: the losses do not "
                                       "fall: %s" % (name, r["losses"]))
            elif fused.captures != 1 or \
                    fused.replays != LOOP["epochs"] * k - 2:
                raise RuntimeError("imagenet loop %s: %d captures, %d "
                                   "replays" % (name, fused.captures,
                                                fused.replays))
            # the files the epoch-end callback wrote, read back bitwise
            for ep, saved in r["params"].items():
                _, arg, aux = mt.model.load_checkpoint(prefix, ep,
                                                       ctx=mt.cpu())
                loaded = {**arg, **aux}
                bad = [n for n, v in saved.items()
                       if not torch.equal(loaded[n].data, v)]
                if bad or sorted(loaded) != sorted(saved):
                    raise RuntimeError("imagenet loop %s: epoch %d's "
                                       "checkpoint differs: %s"
                                       % (name, ep, bad[:3]))
            log("  train_imagenet.py's loop, kvstore %s, %s: %.1f images/s "
                "over %d steps (%.1f without the epoch-end saves), saves %s "
                "ms; losses %s; B1 through the wrapper %s; captures %d  [%s]"
                % (kv_name if kv_name == "tpu_sync"
                   else "mt.kv.create('local')",
                   "per step" if k == 1 else "K %d" % k, r["img_per_s"],
                   r["steps"], r["img_per_s_without_saves"],
                   ["%.0f" % s for s in r["save_ms"]],
                   "%.3f -> %.3f" % (r["losses"][0], r["losses"][-1])
                   if r["losses"] else "not read (K 30)", b1,
                   fused.captures, card))
            for ln in r["lines"]:
                log("    " + ln)
            r.pop("params")
            runs[name] = r
            fused.release_graphs()
            del mod, fused
            released(dev)
    # the same per-step loop over one batch already on the card: the
    # records' share of the per-step wall
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    X, Y = image_batch(DATA["batch"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mod.fit(OneBatchIter(X, Y, LOOP["batches"], dev), num_epoch=1,
            eval_metric="acc", kvstore="tpu_sync", optimizer="sgd",
            optimizer_params=dict(IMAGENET_SGD), arg_params=p0,
            aux_params=aux0, batch_end_callback=[mt.callback.Speedometer(
                DATA["batch"], LOOP["disp"])])
    torch.cuda.synchronize()
    one = LOOP["batches"] * DATA["batch"] / (time.perf_counter() - t0)
    runs["one_batch"] = {"img_per_s": one}
    log("  the same per-step loop (tpu_sync, acc, Speedometer) over one "
        "batch already on the card: %.1f images/s over %d steps  [%s]"
        % (one, LOOP["batches"], card))
    del mod
    released(dev)
    # --load-epoch 1: load_checkpoint and a new Module's fit from epoch 1
    prefix = os.path.join(out_dir, "tpu_sync-k1")
    _, arg, aux = mt.model.load_checkpoint(prefix, 1)
    mod, r = imagenet_fit(sym, path, dev, "tpu_sync", 1, arg, aux,
                          prefix + "-restart", begin_epoch=1)
    if r["steps"] != LOOP["batches"] or not np.isfinite(r["losses"]).all():
        raise RuntimeError("the --load-epoch restart ran %d steps, losses %s"
                           % (r["steps"], r["losses"]))
    log("  --load-epoch 1 restart (load_checkpoint, fit(arg_params, "
        "aux_params, begin_epoch=1)): %d steps, %.1f images/s, losses "
        "%.3f -> %.3f  [%s]" % (r["steps"], r["img_per_s"], r["losses"][0],
                                r["losses"][-1], card))
    r.pop("params")
    runs["restart"] = r
    mod._fused.release_graphs()
    del mod
    released(dev)
    report["imagenet_loop"]["runs"] = runs
    return b1_k1


def resume_fit(sym, path, dev, p0, aux0, steps, ckpt=None):
    """``fit`` at K 30 over ``steps`` batches of the records (one epoch)
    -> (module, the labels of the iterator's next batch)."""
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    it = record_iter(path)
    try:
        mod.fit(mt.io.ResizeIter(it, steps, reset_internal=False),
                num_epoch=1, eval_metric=None, kvstore="tpu_sync",
                optimizer="sgd", optimizer_params=dict(IMAGENET_SGD),
                arg_params=p0, aux_params=aux0, checkpoint=ckpt,
                steps_per_dispatch=LOOP["k"])
        try:
            nxt = next(it)
        except StopIteration:   # the records' epoch ended with the leg
            it.reset()
            nxt = next(it)
        nxt = card_labels(nxt).cpu().clone()
    finally:
        it.close()
    return mod, nxt


def module_trajectory(mod):
    """Parameters, moving statistics and momentum on the host."""
    args, aux = mod.get_params()
    out = {k: v.cpu() for k, v in {**args, **aux}.items()}
    for k, st in mod._fused_opt_state.items():
        out["mom:" + k] = st[0].cpu().clone()
    return out


def resume_check(sym, path, dev, card, p0, aux0, report):
    """Part c: 60 steps with a snapshot every 30, a new Module resumed
    under MXNET_RESUME_DIR to 120, against an uninterrupted 120; cuDNN
    held to deterministic algorithms. Then a blocking and an async save
    timed."""
    root = os.path.join(REPO, "build", "chip_smoke", "resume")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    prev = os.environ.pop("MXNET_RESUME_DIR", None)
    try:
        cm = mt.checkpoint.CheckpointManager(
            root, save_every=LOOP["resume_every"], keep_n=2)
        mod, _ = resume_fit(sym, path, dev, p0, aux0, LOOP["resume_steps"],
                            ckpt=cm)
        steps = cm.steps()
        mod._fused.release_graphs()
        del mod
        released(dev)
        if steps[0] != LOOP["resume_steps"]:
            raise RuntimeError("the interrupted run saved steps %s" % steps)
        os.environ["MXNET_RESUME_DIR"] = root
        t0 = time.perf_counter()
        mod, next_r = resume_fit(sym, path, dev, p0, aux0,
                                 LOOP["total_steps"],
                                 ckpt=mt.checkpoint.CheckpointManager(
                                     root, save_every=LOOP["resume_every"],
                                     keep_n=2))
        resumed_s = time.perf_counter() - t0
        del os.environ["MXNET_RESUME_DIR"]
        resumed = module_trajectory(mod)
        if mod._optimizer.num_update != LOOP["total_steps"]:
            raise RuntimeError("the resumed run ended at update %d"
                               % mod._optimizer.num_update)
        # a blocking and an async save of this state, timed
        blocking = mt.checkpoint.CheckpointManager(
            os.path.join(root, "timed"), async_save=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = mt.checkpoint.module_state(mod)
        state_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        blocking.save(state, 1)
        block_ms = (time.perf_counter() - t0) * 1e3
        asyn = mt.checkpoint.CheckpointManager(os.path.join(root, "async"),
                                               async_save=True)
        t0 = time.perf_counter()
        asyn.save(state, 1)
        async_ret_ms = (time.perf_counter() - t0) * 1e3
        asyn.wait()
        async_ms = (time.perf_counter() - t0) * 1e3
        _, man = blocking.restore()
        mod._fused.release_graphs()
        del mod, state
        released(dev)
        mod, next_u = resume_fit(sym, path, dev, p0, aux0,
                                 LOOP["total_steps"])
        full = module_trajectory(mod)
        mod._fused.release_graphs()
        del mod
        released(dev)
        diff = {k: float((resumed[k].float() - full[k].float()).abs().max())
                for k in full if not torch.equal(resumed[k], full[k])}
        labels_equal = torch.equal(next_r, next_u)
        spread = None
        if diff:
            # two uninterrupted runs: is the card's own run bitwise?
            mod, _ = resume_fit(sym, path, dev, p0, aux0,
                                LOOP["total_steps"])
            again = module_trajectory(mod)
            mod._fused.release_graphs()
            del mod
            released(dev)
            spread = {k: float((again[k].float() - full[k].float()).abs()
                               .max()) for k in full}
            over = [k for k, d in diff.items() if d > spread[k]]
            if not any(spread.values()) or over:
                raise RuntimeError("the resumed run is off the uninterrupted"
                                   " one beyond two runs' spread: %s"
                                   % {k: (diff[k], spread[k])
                                      for k in over[:5]})
        if not labels_equal:
            raise RuntimeError("the resumed run's next batch has other "
                               "labels")
    finally:
        torch.backends.cudnn.deterministic = det
        if prev is not None:
            os.environ["MXNET_RESUME_DIR"] = prev
    log("  resume (cuDNN deterministic, K %d): %d steps snapshotted every %d"
        " (kept %s), a new Module resumed under MXNET_RESUME_DIR to %d in "
        "%.1f s; against the uninterrupted %d: %d of %d tensors (parameters,"
        " moving statistics, momentum) differ%s, the next batch's labels "
        "equal %s; a snapshot of %.1f MB: module_state %.0f ms, blocking "
        "save %.0f ms, async save returns in %.1f ms and is written in %.0f"
        " ms  [%s]" % (LOOP["k"], LOOP["resume_steps"], LOOP["resume_every"],
                       steps, LOOP["total_steps"], resumed_s,
                       LOOP["total_steps"], len(diff), len(full),
                       "" if not diff else " (within two uninterrupted "
                       "runs' spread %s)" % max(spread.values()),
                       labels_equal, man["size"] / 1e6, state_ms, block_ms,
                       async_ret_ms, async_ms, card))
    report["imagenet_loop"]["resume"] = {
        "differ": diff, "spread": spread, "labels_equal": labels_equal,
        "snapshot_bytes": man["size"], "module_state_ms": state_ms,
        "blocking_save_ms": block_ms, "async_return_ms": async_ret_ms,
        "async_save_ms": async_ms, "resumed_s": resumed_s}


def predict_monitor_check(sym, path, dev, card, p0, aux0, report):
    """Part d: ``predict``, ``iter_predict`` and ``score`` over 2 batches
    against ``forward``; then ``install_monitor`` for 3 steps."""
    mod, _ = resume_fit(sym, path, dev, p0, aux0, LOOP["k"])
    plain = dict(rand_crop=False, rand_mirror=False, shuffle=False)
    it = record_iter(path, **plain)
    want, labels = [], []
    for _ in range(LOOP["predict_batches"]):
        b = next(it)
        mod.forward(b, is_train=False)
        want.append(mod.get_outputs()[0].clone())
        labels.append(card_labels(b).clone())
    it.close()
    want = torch.cat(want)
    it = record_iter(path, **plain)
    got = mod.predict(it, num_batch=LOOP["predict_batches"])._data
    per = torch.cat([o[0] for o, _, _ in mod.iter_predict(
        it, num_batch=LOOP["predict_batches"])])
    score = mod.score(it, "acc", num_batch=LOOP["predict_batches"])[0][1]
    it.close()
    acc = float((want.argmax(1).float() == torch.cat(labels).float())
                .float().mean())
    if not (torch.equal(got, want) and torch.equal(per, want)) \
            or abs(score - acc) > 1e-12:
        raise RuntimeError("predict/iter_predict/score against forward: "
                           "max diff %g, %g; score %r, forward's %r"
                           % (float((got - want).abs().max()),
                              float((per - want).abs().max()), score, acc))
    # install_monitor: the fused step dropped, its momentum kept
    mom = {n: mod._fused_opt_state[n][0] for n in mod._fused.param_names}
    mom0 = {n: t.clone() for n, t in mom.items()}
    mon = mt.monitor.Monitor(1, pattern=MONITOR_PATTERN, sort=True)
    seen = []
    mon.toc_print = lambda: seen.append(mon.toc())
    it = record_iter(path)
    t0 = time.perf_counter()
    try:
        mod.fit(mt.io.ResizeIter(it, LOOP["monitor_steps"],
                                 reset_internal=False),
                num_epoch=1, eval_metric=None, monitor=mon)
        torch.cuda.synchronize()
    finally:
        it.close()
    mon_s = time.perf_counter() - t0
    idx = {n: i for i, n in enumerate(mod._param_names)}
    kept = all(mod._updater.states[idx[n]] is t for n, t in mom.items())
    moved = not torch.equal(mom["fc1_weight"], mom0["fc1_weight"])
    last = {name: stat for _, name, stat in seen[-1]}
    ex = mod._exec
    arrays = dict(zip(ex._symbol.list_outputs(), ex.outputs))
    arrays.update(ex.arg_dict)
    bad = [n for n, s in last.items()
           if s != np.abs(arrays[n].detach().float().cpu().numpy()).mean()]
    if mod._fused is not None or not kept or not moved or bad \
            or len(seen) != LOOP["monitor_steps"] or len(last) != 3:
        raise RuntimeError("install_monitor: fused %s, momentum kept %s "
                           "moved %s, stats off %s, %d tocs of %s"
                           % (mod._fused, kept, moved, bad, len(seen),
                              sorted(last)))
    log("  predict/iter_predict over %d record batches bitwise forward; "
        "score acc %.4f; install_monitor: fused step dropped, momentum kept "
        "in the Updater and moved, %d eager steps in %.1f s, the Monitor's "
        "statistics %s equal asnumpy of the arrays  [%s]"
        % (LOOP["predict_batches"], score, LOOP["monitor_steps"], mon_s,
           {k: "%.4g" % v for k, v in last.items()}, card))
    report["imagenet_loop"]["predict_monitor"] = {
        "score": score, "monitor_s": mon_s,
        "stats": {k: float(v) for k, v in last.items()}}
    del mod
    released(dev)


def gluon_resnet(ctx, p0=None):
    mt.random.seed(0)
    net = mt.gluon.model_zoo.vision.resnet50_v1(classes=1000)
    net.initialize(mt.init.Xavier(factor_type="in", magnitude=2, seed=0),
                   ctx=ctx)
    with mt.autograd.predict_mode():
        net(mt.nd.zeros((1, 3, 224, 224), ctx=ctx))
    if p0 is not None:
        for p, v in zip(net.collect_params().values(), p0):
            p.set_data(mt.nd.NDArray(v))
    net.hybridize()
    return net


def gluon_kv_check(dev, card, report):
    """Part e: phase 11's Gluon ResNet-50, 3 steps with a ``KVStore``
    object against ``kvstore="device"`` (bitwise); with 2-bit compression
    against numpy's quantize of the card's gradients; then
    ``save_checkpoint``/``restore_checkpoint`` into a new net, whose next
    step is bitwise."""
    ctx = mt.gpu(0)
    B = LOOP["gluon_batch"]
    rng = np.random.RandomState(0)
    xs = [mt.nd.array(rng.randn(B, 3, 224, 224).astype(np.float32), ctx=ctx)
          for _ in range(LOOP["gluon_steps"] + 1)]
    ys = [mt.nd.array(rng.randint(0, 1000, (B,)).astype(np.float32),
                      ctx=ctx) for _ in range(LOOP["gluon_steps"] + 1)]
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    net = gluon_resnet(ctx)
    p0 = [p.data()._data.detach().clone()
          for p in net.collect_params().values()]

    def step(net, tr, i, before=None):
        with mt.autograd.record():
            loss = loss_fn(net(xs[i]), ys[i])
        loss.backward()
        if before is not None:
            before.append([p.grad()._data.detach().cpu().numpy().copy()
                           for p in tr._params if p.grad_req != "null"])
        tr.step(B)

    def run(kvstore, compression=None):
        for p, v in zip(net.collect_params().values(), p0):
            p.set_data(mt.nd.NDArray(v))
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              dict(RESNET_SGD, wd=1e-4), kvstore=kvstore,
                              compression_params=compression)
        grads, pulled = [], []
        for i in range(LOOP["gluon_steps"]):
            step(net, tr, i, grads if compression else None)
            if compression:
                pulled.append([p.grad()._data.detach().cpu().numpy()
                               for p in tr._params if p.grad_req != "null"])
        torch.cuda.synchronize()
        return tr, [p.data()._data.detach().clone()
                    for p in net.collect_params().values()], grads, pulled

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _, by_name, _, _ = run("device")
        tr, by_obj, _, _ = run(mt.kv.create("device"))
        differ = sum(not torch.equal(a, b) for a, b in zip(by_name, by_obj))
        if differ:
            raise RuntimeError("Gluon: a KVStore object against "
                               "kvstore='device': %d tensors differ" % differ)
        thr = KV["threshold"]
        ctr, _, grads, pulled = run("device", {"type": "2bit",
                                               "threshold": thr})
        res = [np.zeros_like(g) for g in grads[0]]
        bad, nonzero = 0, 0
        for g_step, p_step in zip(grads, pulled):
            for j, (g, got) in enumerate(zip(g_step, p_step)):
                acc = g + res[j]
                q = np_quantize(acc, thr)
                res[j] = acc - q
                bad += not np.array_equal(got, q)
                nonzero += int(np.count_nonzero(q))
        if bad:
            raise RuntimeError("Gluon 2bit: %d pulled gradients are not "
                               "numpy's quantize" % bad)
        # save_checkpoint, then restore_checkpoint into a new net
        root = os.path.join(REPO, "build", "chip_smoke", "gluon_ckpt")
        import shutil
        shutil.rmtree(root, ignore_errors=True)
        tr._checkpoint = mt.checkpoint.CheckpointManager(root,
                                                         async_save=False)
        t0 = time.perf_counter()
        tr.save_checkpoint()
        save_ms = (time.perf_counter() - t0) * 1e3
        net2 = gluon_resnet(ctx)
        tr2 = mt.gluon.Trainer(net2.collect_params(), "sgd",
                               dict(RESNET_SGD, wd=1e-4), kvstore="device",
                               checkpoint=mt.checkpoint.CheckpointManager(
                                   root))
        logging.disable(logging.WARNING)   # names matched by position
        try:
            restored = tr2.restore_checkpoint()
        finally:
            logging.disable(logging.NOTSET)
        i = LOOP["gluon_steps"]
        step(net, tr, i)
        step(net2, tr2, i)
        torch.cuda.synchronize()
        after = [p.data()._data for p in net.collect_params().values()]
        after2 = [p.data()._data for p in net2.collect_params().values()]
        differ2 = sum(not torch.equal(a, b) for a, b in zip(after, after2))
        if restored != LOOP["gluon_steps"] or differ2:
            raise RuntimeError("Gluon restore_checkpoint: step %s, %d "
                               "tensors differ after the next step"
                               % (restored, differ2))
    finally:
        torch.backends.cudnn.deterministic = det
    log("  Gluon resnet50_v1, batch %d, %d steps: Trainer(kvstore="
        "mt.kv.create('device')) bitwise kvstore='device'; 2-bit "
        "(threshold %.1f) pulled gradients bitwise numpy's quantize of the "
        "card's gradients over %d steps (%d nonzero codes); save_checkpoint "
        "%.0f ms, restore_checkpoint into a new net at step %d, the next "
        "step bitwise  [%s]" % (B, LOOP["gluon_steps"], thr,
                                LOOP["gluon_steps"], nonzero, save_ms,
                                restored, card))
    report["imagenet_loop"]["gluon"] = {"save_ms": save_ms,
                                        "nonzero_codes": nonzero}
    del net, net2, tr, tr2, ctr
    released(dev)


def imagenet_path(dev, card, report):
    """Phase 19 (see the module docstring) -> B1 launches by form on the
    loop at K = 1."""
    t_phase = time.perf_counter()
    log("phase 19: kvstore, checkpoints and resume, and train_imagenet.py's "
        "own loop (ResNet-50 bf16, batch %d, records of phase 18)"
        % DATA["batch"])
    report["imagenet_loop"] = {}
    rows = [kv_case(dev, kind, two, compress, card)
            for kind in ("local", "device") for two in (False, True)
            for compress in (False, True)]
    packed = kv_pack_check(dev)
    log("  _pack_2bit on the card bitwise numpy's (%d bytes for 1001 "
        "values), _dequantize_2bit gives the quantized values back"
        % packed)
    sym = resnet50()
    p0, aux0 = resnet_init(sym, dev)
    lists = kv_resnet_lists(dev, card, sym, p0)
    report["imagenet_loop"]["kvstore"] = {"cases": rows, "resnet50": lists}
    path = os.path.join(REPO, "build", "chip_smoke", "records.rec")
    b1 = imagenet_loop(sym, path, dev, card, p0, aux0, report)
    resume_check(sym, path, dev, card, p0, aux0, report)
    predict_monitor_check(sym, path, dev, card, p0, aux0, report)
    gluon_kv_check(dev, card, report)
    wall = time.perf_counter() - t_phase
    report["imagenet_loop"]["wall_s"] = wall
    log("phase 19 wall: %.1f s" % wall)
    return b1


# ---------------------------------- the other ImageNet networks (phase 20)
INCEPTION = dict(chw=(3, 299, 299), sites=94, distinct=18, bf16_batch=128,
                 f32_batch=32, k1_steps=10, k=30, windows=3,
                 cut_chw=(3, 139, 139), cut_batch=2, loss_rel=5e-3)
ALEXNET = dict(chw=(3, 224, 224), batch=128, steps=5, cut_batch=2,
               # fc6 and fc7: FullyConnected(+bias) -> ReLU, each one B5
               # launch a forward (kernels/graph_fuse.py's fc_act plan)
               b5_shape=(128, 4096), b5_sites=2)
# train_imagenet.py --benchmark 1's fit: wd 1e-4, the key chain seeded 0
BENCH = dict(sgd=IMAGENET_SGD, seed=0)
ZOO = dict(batch=32, cut_batch=2, reps=3, train_steps=3,
           train=("mobilenetv2_1.0", "densenet121"))


def inception_v3():
    return mt.models.inception_v3_symbol(num_classes=1000)


def held_counts(what, want):
    """Every kernel's launch count since ``reset_all_counts``, held to
    ``want`` (the kernels it names; every other kernel 0), and no tier
    fallback -> the counts."""
    got = all_counts()
    full = dict.fromkeys(got, 0)
    full.update(want)
    fallback = tier.stats()["fallback"]
    if got != full or fallback:
        raise RuntimeError("%s: kernel launches %s, want %s; tier fallback "
                           "%s" % (what, got, want, fallback))
    return got


def symbol_flops(sym, chw):
    """Forward FLOPs of one image: 2 x the multiply-adds of every
    Convolution and FullyConnected, from the port's shape inference."""
    shapes = _infer_shapes(sym, {"data": (1,) + tuple(chw)})
    flops = 0
    for n in sym._topo():
        if not n.is_variable and n.op.name in ("Convolution",
                                               "FullyConnected"):
            w = shapes[("var", n.inputs[1][0].name)]
            flops += 2 * int(np.prod(shapes[(id(n), 0)])) \
                * int(np.prod(w[1:]))
    return flops


def inception_b1_phase(sites, dev):
    """Part a: B1 against its plain version at each distinct site shape of
    Inception-v3, bf16 at batch 128 and f32 at batch 32 (phase 3's
    tolerances), each timed as in phase 3 beside its bound; the sums over
    the 94 sites -> (max abs err by dtype, rows, totals by dtype)."""
    distinct = sorted({chw for _, chw in sites})
    forms = {f for f, _ in sites}
    if len(sites) != INCEPTION["sites"] or forms != {"bn_act"} \
            or len(distinct) != INCEPTION["distinct"]:
        raise RuntimeError("Inception-v3 fusion census: %d sites of %s, %d "
                           "distinct shapes; expected 94 bn_act, 18"
                           % (len(sites), sorted(forms), len(distinct)))
    elems = sum(int(np.prod(chw)) for _, chw in sites)
    max_err, rows, totals = {}, [], {}
    for dtype, batch in ((torch.bfloat16, INCEPTION["bf16_batch"]),
                         (torch.float32, INCEPTION["f32_batch"])):
        dt = str(dtype).replace("torch.", "")
        mine = [b1_class_row("bn_act", (batch,) + chw, dtype,
                             sum(1 for _f, c in sites if c == chw), dev,
                             300 + i, "inception ")
                for i, chw in enumerate(distinct)]
        max_err[dt] = max(r["max_abs_err"] for r in mine)
        totals[dt] = b1_totals(mine, "Inception-v3 %s forward at batch %d, "
                               "94 sites" % (dt, batch))
        rows += mine
    log("B1 vs plain at Inception-v3's 18 site shapes (%.3f M elements an "
        "image over the 94 sites), bf16 batch %d and f32 batch %d, agree; "
        "max abs err %s" % (elems / 1e6, INCEPTION["bf16_batch"],
                            INCEPTION["f32_batch"], json.dumps(max_err)))
    return max_err, rows, totals


def inception_serve(sym, dev, card, report):
    """Part b: Inception-v3 exported with a dynamic batch and served at
    buckets (1, 8, 32) as phase 4 serves ResNet-50 -> B1 launches."""
    chw = INCEPTION["chw"]
    args, aux = draw_params(sym, chw)
    os.makedirs(os.path.join(REPO, "build", "chip_smoke"), exist_ok=True)
    path = os.path.join(REPO, "build", "chip_smoke", "inception_v3.mxtorch")
    t0 = time.perf_counter()
    meta = mt.serving.export_compiled(sym, args, aux,
                                      {"data": (None,) + chw}, path,
                                      device=dev)
    log("  export: %.2fs, %.1f MB, kernel_tier %s"
        % (time.perf_counter() - t0, os.path.getsize(path) / 1e6,
           json.dumps(meta["kernel_tier"])))
    rng = np.random.RandomState(1)
    inputs = ([rng.randn(1, *chw).astype("f4") for _ in range(8)]
              + [rng.randn(8, *chw).astype("f4"),
                 rng.randn(32, *chw).astype("f4")])
    # -- the main path, every count zeroed just before it
    reset_all_counts()
    srv = mt.serve.Server(path, buckets=BUCKETS, batch_timeout_ms=2)
    outs = serve_burst(srv, inputs)
    inputs += [inputs[0], inputs[8]]
    for x in inputs[-2:]:
        outs.append(srv.predict(data=x, timeout_ms=300000)[0])
        check_answer(outs[-1], x.shape[0])
    torch.cuda.synchronize()
    est = srv.model.engine_cache.stats()
    forwards = est["builds"] + sum(e["calls"] for e in est["engines"].values())
    log("  served: %d requests, %d forwards (engines %s), launches %s, "
        "tier %s" % (len(outs), forwards, sorted(est["engines"]),
                     all_counts(), json.dumps(tier.stats()["dispatch"])))
    launches = held_counts("Inception-v3 served (94 B1 launches a forward)",
                           {"bn_act": 94 * forwards})
    if sorted(est["engines"], key=int) != [str(b) for b in BUCKETS]:
        raise RuntimeError("buckets served: %s" % sorted(est["engines"]))
    with mt.config.override(kernel_tier="off"):
        srv_off = mt.serve.Server(path, buckets=BUCKETS, batch_timeout_ms=2)
    off = [srv_off.predict(data=x, timeout_ms=300000)[0] for x in inputs]
    srv_off.close()
    err_off = max(float(np.abs(a - b).max()) for a, b in zip(outs, off))
    log("  tier auto vs off on the card: max abs err %g" % err_off)
    if err_off > 1e-5 or bn_act.launches != 94 * forwards:
        raise RuntimeError("Inception-v3 served outputs disagree with tier "
                           "off (%g), or tier off launched B1" % err_off)
    lat = {}
    for b in BUCKETS:
        srv.model.engine_cache.engine(b)
        x = np.random.RandomState(b).randn(b, *chw).astype("f4")
        samples = []
        t_all = time.perf_counter()
        for _ in range(20):
            t1 = time.perf_counter()
            check_answer(srv.predict(data=x, timeout_ms=300000)[0], b)
            samples.append((time.perf_counter() - t1) * 1e3)
        wall = time.perf_counter() - t_all
        lat[str(b)] = {"p50_ms": float(np.percentile(samples, 50)),
                       "p99_ms": float(np.percentile(samples, 99)),
                       "img_per_s": 20 * b / wall}
        log("  bucket %2d: p50 %.3f ms  p99 %.3f ms  %.1f img/s  [%s]"
            % (b, lat[str(b)]["p50_ms"], lat[str(b)]["p99_ms"],
               lat[str(b)]["img_per_s"], card))
    srv.close()
    cpu = mt.serving.CompiledModel.load(path, device="cpu")
    ref = cpu.predict(data=inputs[0])[0].numpy()
    err_cpu = float(np.abs(outs[0] - ref).max())
    log("  served on the card vs the CPU (one image): max abs err %g"
        % err_cpu)
    if err_cpu > 1e-5:
        raise RuntimeError("Inception-v3 served outputs disagree with the "
                           "CPU: %g" % err_cpu)
    report["inception_v3"]["serve"] = {
        "launches": launches, "forwards": forwards, "err_vs_off": err_off,
        "err_vs_cpu": err_cpu, "latency": lat, "engines": est}
    return launches


def inception_train(sym, dev, card, report, b1_tot):
    """Part c: train_imagenet.py's benchmark loop on Inception-v3, bf16 at
    batch 128: 10 steps per step, tier off's first step, then 3 windows
    at K 30 and a profiled one -> (B1 launches at K 1, the window's
    census)."""
    I = INCEPTION
    chw, B_, K, W = I["chw"], I["bf16_batch"], I["k"], I["windows"]
    p0, aux0 = resnet_init(sym, dev, chw, "gaussian")
    X, Y = image_batch(B_, chw=chw)
    flops = 3 * symbol_flops(sym, chw)
    # -- per step: every count zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_counts()
    mod, losses, st = resnet_fit(sym, X, Y, dev, I["k1_steps"], p0, aux0,
                                 True, **BENCH)
    mem = torch.cuda.max_memory_allocated(dev)
    launches = held_counts("Inception-v3 per-step fit (94 B1 launches a "
                           "forward)", {"bn_act": 94 * I["k1_steps"]})
    if not falling(losses):
        raise RuntimeError("Inception-v3 losses do not fall: %s" % losses)
    n_aux = check_moving_stats(mod, aux0)
    steps_ms = list(np.diff(st)[1:] * 1e3)
    prof = resnet_step_profile(mod)
    k1 = log_step("Inception-v3 bf16 per step (train_imagenet.py "
                  "--benchmark 1, K 1), batch %d" % B_, steps_ms, B_,
                  ("989 TFLOP/s bf16", BF16_FLOPS), prof, mem, card,
                  flops_per_img=flops)
    log("  losses %s; %d moving statistics f32 and moved; B1 in the "
        "profiled step %.3f ms for 94 forward launches (the kernel alone "
        "at these shapes: %.3f ms, bound %.3f ms)"
        % (["%.4f" % x for x in losses], n_aux, prof["b1_ms"],
           b1_tot["bfloat16"]["kernel_ms"],
           b1_tot["bfloat16"]["bound_ms"]))
    del mod
    released(dev)
    # -- tier off, the first step from the same start
    before = bn_act.launches
    with mt.config.override(kernel_tier="off"):
        mod_off, loss_off, _st = resnet_fit(sym, X, Y, dev, 1, p0, aux0,
                                            True, **BENCH)
    rel_off = abs(loss_off[0] - losses[0]) / abs(losses[0])
    log("  tier off, step 1 from the same start: loss %.5f against %.5f at "
        "auto (relative %.3g)" % (loss_off[0], losses[0], rel_off))
    if rel_off > I["loss_rel"] or bn_act.launches != before:
        raise RuntimeError("tier off's first loss is %.3g from auto's, or "
                           "tier off launched B1" % rel_off)
    del mod_off
    released(dev)
    # -- K 30: train_imagenet.py --steps-per-dispatch 30, 3 epochs
    torch.cuda.reset_peak_memory_stats(dev)
    reset_all_counts()
    mod, windows, stamps = resnet_fit(sym, X, Y, dev, K, p0, aux0, True,
                                      k=K, epochs=W, **BENCH)
    fused = mod._fused
    mem_k = torch.cuda.max_memory_allocated(dev)
    # through the wrapper: two warm-up steps and the capture
    wrapper_k = held_counts("Inception-v3 K %d" % K, {"bn_act": 94 * 3})
    if fused.captures != 1 or fused.replays != W * K - 2:
        raise RuntimeError("Inception-v3 K %d: %d captures, %d replays"
                           % (K, fused.captures, fused.replays))
    lab = torch.from_numpy(Y).to(dev).long()
    loss_k = window_losses(windows, lab)
    if not falling(loss_k) \
            or abs(loss_k[0] - losses[0]) / losses[0] > I["loss_rel"]:
        raise RuntimeError("K %d losses %s against K 1's first %.5f"
                           % (K, loss_k[:3], losses[0]))
    step_k = (stamps[-1] - stamps[1]) / ((W - 1) * K) * 1e3
    cen = graph_census(lambda: grouped_fit(mod, OneBatchIter(X, Y, K, dev),
                                           K))
    got = {f: cen["counts"].get(f, 0) for f in ("bn_act", "bn_act_res")}
    log("Inception-v3 bf16 K %d (%d epochs of %d steps, one captured "
        "graph): step %.2f ms over windows 2-%d, %.1f images/s, %.1f%% of "
        "the bf16 "
        "peak; losses %.4f -> %.4f; peak memory %.2f GB; profiled window: "
        "B1 %s (%.1f a step), %.3f ms of B1 a step, %.2f ms device of %.2f "
        "ms wall (busy %.1f%%); top %s  [%s]"
        % (K, W, K, step_k, W, B_ / (step_k / 1e3),
           100 * flops * B_ / (step_k / 1e3) / BF16_FLOPS, loss_k[0],
           loss_k[-1], mem_k / 1e9, json.dumps(got), got["bn_act"] / K,
           cen["kernel_ms"].get("bn_act", 0.0) / K, cen["device_ms"],
           cen["wall_ms"], 100 * cen["busy_share"],
           "; ".join(cen["top_kernels"][:5]), card))
    if got != {"bn_act": 94 * K, "bn_act_res": 0}:
        raise RuntimeError("replayed window census %s, want 94 x %d"
                           % (cen["counts"], K))
    fused.release_graphs()
    del mod, fused, windows
    released(dev)
    report["inception_v3"]["train"] = {
        "k1": k1, "losses": losses, "tier_off_step1_rel": rel_off,
        "launches_k1": launches, "model_flops_per_img": flops,
        "k30": {"step_ms": step_k, "img_per_s": B_ / (step_k / 1e3),
                "losses": loss_k, "peak_memory_bytes": mem_k,
                "wrapper_launches": wrapper_k, "census": cen}}
    return launches, got


def lrn_card_vs_cpu(dev):
    """Part d: the LRN op of AlexNet at its two sites (batch 2, f32),
    forward and input gradient on the card against the CPU, within 1e-5
    of each tensor's largest magnitude -> the worst error."""
    from mxnet_tpu_torch.ops import nn as tnn
    worst = 0.0
    for i, shape in enumerate(((2, 96, 54, 54), (2, 256, 26, 26))):
        rng = np.random.RandomState(40 + i)
        x = np.maximum(rng.randn(*shape) * 20, 0).astype(np.float32)
        cot = rng.randn(*shape).astype(np.float32)
        res = []
        for d in (dev, "cpu"):
            xt = torch.from_numpy(x).to(d).requires_grad_(True)
            y = tnn.lrn(xt, nsize=5, alpha=1e-4, beta=0.75, knorm=2)
            (y * torch.from_numpy(cot).to(d)).sum().backward()
            res.append((y.detach().cpu(), xt.grad.cpu()))
        for a, b in zip(*res):
            err = float((a - b).abs().max() / b.abs().max())
            worst = max(worst, err)
            if err > 1e-5:
                raise RuntimeError("LRN at %s: card vs CPU %g of the largest "
                                   "magnitude" % (shape, err))
    return worst


def alexnet_b5_check(dev):
    """Part d: B5 at AlexNet's fc6 and fc7 shape, (128, 4096) + bias ->
    ReLU, f32 and bf16, held by ``b5_check`` as phase 7 holds it, each
    timed beside its bound -> {dtype: row}."""
    return {str(dt)[6:]: b5_row(ALEXNET["b5_shape"], dt, dev,
                                "AlexNet's fc6/fc7")
            for dt in (torch.float32, torch.bfloat16)}


def alexnet_path(dev, card, report):
    """Part d: AlexNet through train_imagenet.py's loop (3x224x224, batch
    128), f32 and bf16, 5 steps each, its fc6 and fc7 each one B5 launch
    a forward; B5 at that shape against its plain version; LRN card
    against CPU -> {dtype: B5 row with the run's launches}."""
    sym = mt.models.alexnet_symbol(num_classes=1000)
    chw, B_, steps = ALEXNET["chw"], ALEXNET["batch"], ALEXNET["steps"]
    lrn_err = lrn_card_vs_cpu(dev)
    log("  AlexNet's LRN (batch 2, f32, both sites) on the card vs the CPU: "
        "forward and gradient within %.3g of the largest magnitude"
        % lrn_err)
    b5 = alexnet_b5_check(dev)
    p0, aux0 = resnet_init(sym, dev, chw, "gaussian")
    X, Y = image_batch(B_, chw=chw)
    flops = 3 * symbol_flops(sym, chw)
    runs = {}
    for mp in (False, True):
        what = "bf16" if mp else "f32"
        torch.cuda.reset_peak_memory_stats(dev)
        # the main path: every count zeroed just before, read just after
        reset_all_counts()
        mod, losses, st = resnet_fit(sym, X, Y, dev, steps, p0, aux0, mp,
                                     **BENCH)
        counts = held_counts(
            "AlexNet %s (B5 at fc6 and fc7 each forward)" % what,
            {"scale_bias_act": ALEXNET["b5_sites"] * steps})
        b5["bfloat16" if mp else "float32"]["launches"] = \
            counts["scale_bias_act"]
        mem = torch.cuda.max_memory_allocated(dev)
        steps_ms = list(np.diff(st)[1:] * 1e3)
        p50 = float(np.median(steps_ms))
        log("AlexNet %s, batch %d, per step: step p50 %.2f ms over steps "
            "2-%d, %.1f images/s, %.1f%% of the %s peak; losses %s; B5 "
            "launches %d (2 a forward); peak memory %.2f GB  [%s]"
            % (what, B_, p50, steps, B_ / (p50 / 1e3),
               100 * flops * B_ / (p50 / 1e3)
               / (BF16_FLOPS if mp else F32_FLOPS),
               "989 TFLOP/s bf16" if mp else "67 TFLOP/s f32",
               ["%.4f" % x for x in losses], counts["scale_bias_act"],
               mem / 1e9, card))
        if not np.isfinite(losses).all():
            raise RuntimeError("AlexNet %s losses %s" % (what, losses))
        runs[what] = {"step_ms": steps_ms, "step_ms_p50": p50,
                      "img_per_s": B_ / (p50 / 1e3), "losses": losses,
                      "peak_memory_bytes": mem, "launches": counts}
        del mod
        released(dev)
    report["alexnet"] = {"lrn_card_vs_cpu": lrn_err, "runs": runs,
                         "model_flops_per_img": flops, "b5": b5}
    return b5


def zoo_net(name, ctx, x):
    """A zoo net on ``ctx``, Xavier from the key chain seeded 0, its
    deferred shapes completed by an eager forward of ``x`` -> (net, that
    forward's output)."""
    net = mt.gluon.model_zoo.get_model(name)
    mt.random.seed(0)
    net.initialize(mt.init.Xavier(), ctx=ctx)
    with mt.autograd.predict_mode():
        out = net(x)
    return net, out


def zoo_path(dev, card, report):
    """Part e: every ``get_model`` name on the card: a hybridized forward
    at batch 32 (299 for inceptionv3, 224 for the rest) against the eager
    one, and at batch 2 against the CPU with the card's weights; images/s
    of the hybridized forward; then 3 Trainer steps of two families.
    Gluon fuses nothing (as in the JAX package), so no hand-written
    kernel runs here: every count stays 0."""
    gpu, cpu = mt.gpu(0), mt.cpu()
    rows = {}
    reset_all_counts()
    for name in sorted(mt.gluon.model_zoo.vision._MODELS):
        side = 299 if name == "inceptionv3" else 224
        x_np = np.random.RandomState(0).randn(ZOO["batch"], 3, side,
                                              side).astype(np.float32)
        x = mt.nd.array(x_np, ctx=gpu)
        net, eager = zoo_net(name, gpu, x)
        eager = eager.asnumpy()
        with mt.autograd.predict_mode():
            net.hybridize()
            hyb = net(x).asnumpy()
            small = net(x[:ZOO["cut_batch"]]).asnumpy()
            samples = []
            for _ in range(ZOO["reps"]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net(x)
                torch.cuda.synchronize()
                samples.append(time.perf_counter() - t0)
        weights = {n[len(net.prefix):]: p.data().asnumpy()
                   for n, p in net.collect_params().items()}
        with cpu:
            # a net never initialized takes the card's weights
            cnet = mt.gluon.model_zoo.get_model(name)
            mt.gluon.utils.params_from_reference(cnet, weights, ctx=cpu)
            with mt.autograd.predict_mode():
                ref = cnet(mt.nd.array(x_np[:ZOO["cut_batch"]],
                                       ctx=cpu)).asnumpy()
        del cnet, weights
        e_cpu = float(np.abs(small - ref).max()) / max(
            float(np.abs(ref).max()), 1e-30)
        del net
        scale = max(float(np.abs(hyb).max()), 1e-30)
        e_eager = float(np.abs(hyb - eager).max()) / scale
        ips = ZOO["batch"] / float(np.median(samples))
        rows[name] = {"side": side, "img_per_s": ips,
                      "err_vs_eager": e_eager, "err_vs_cpu": e_cpu}
        log("  zoo %-17s %d: hybridized forward at batch %d %.1f images/s; "
            "vs eager %.3g, batch %d vs the CPU %.3g of the largest "
            "magnitude  [%s]" % (name, side, ZOO["batch"], ips, e_eager,
                                 ZOO["cut_batch"], e_cpu, card))
        if hyb.shape != (ZOO["batch"], 1000) or not np.isfinite(hyb).all() \
                or e_eager > 1e-5 or e_cpu > 1e-4:
            raise RuntimeError("zoo %s on the card: shape %s, vs eager %g, "
                               "vs the CPU %g" % (name, hyb.shape, e_eager,
                                                  e_cpu))
        released(dev)
    train = {}
    rng = np.random.RandomState(5)
    for name in ZOO["train"]:
        x = mt.nd.array(rng.randn(ZOO["batch"], 3, 224, 224)
                        .astype(np.float32), ctx=gpu)
        y = mt.nd.array(rng.randint(0, 1000, ZOO["batch"])
                        .astype(np.float32), ctx=gpu)
        net, _ = zoo_net(name, gpu, x)
        net.hybridize()
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   {"learning_rate": 0.05, "momentum": 0.9})
        loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
        losses, steps_ms = [], []
        for _ in range(ZOO["train_steps"]):
            t0 = time.perf_counter()
            with mt.autograd.record():
                loss = loss_fn(net(x), y)
            loss.backward()
            trainer.step(ZOO["batch"])
            losses.append(float(loss.mean().asscalar()))
            steps_ms.append((time.perf_counter() - t0) * 1e3)
        train[name] = {"losses": losses, "step_ms": steps_ms}
        log("  zoo %s: %d Trainer steps (SGD, f32, batch %d): losses %s, "
            "step ms %s  [%s]" % (name, ZOO["train_steps"], ZOO["batch"],
                                  ["%.4f" % v for v in losses],
                                  ["%.1f" % v for v in steps_ms], card))
        if not np.isfinite(losses).all():
            raise RuntimeError("zoo %s losses %s" % (name, losses))
        del net, trainer
        released(dev)
    counts = held_counts("the Gluon zoo (no fused kernel)", {})
    log("  the zoo's forwards and Trainer steps: kernel launches %s"
        % json.dumps(counts))
    report["zoo"] = {"forward": rows, "train": train, "launches": counts}


def vision_path(dev, card, report):
    """Phase 20 (see the module docstring) -> (B1 max abs err by dtype,
    B1 totals by dtype, launches served, launches trained at K 1, the
    replayed window's census, B5's rows at AlexNet's fc6/fc7 by dtype)."""
    t_phase = time.perf_counter()
    log("phase 20: the other ImageNet networks (Inception-v3 served and "
        "trained with B1 at its 94 sites, AlexNet with LRN, the Gluon zoo)")
    report["inception_v3"] = {}
    parts = {}

    def timed(part, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        parts[part] = time.perf_counter() - t0
        log("  part %s: %.1f s" % (part, parts[part]))
        return out
    sym = inception_v3()
    sites = planned_sites(sym, INCEPTION["chw"])
    err, rows, totals = timed("a", inception_b1_phase, sites, dev)
    report["inception_v3"]["b1"] = {"max_abs_err": err, "rows": rows,
                                    "totals": totals}
    serve = timed("b", inception_serve, sym, dev, card, report)
    train, census = timed("c", inception_train, sym, dev, card, report,
                          totals)
    I = INCEPTION
    p0, aux0 = resnet_init(sym, dev, I["cut_chw"], "gaussian")
    timed("c, card vs CPU", resnet_card_vs_cpu, sym, p0, aux0, dev, report,
          "Inception-v3", "inception_v3", I["cut_chw"], I["cut_batch"], 0)
    del p0, aux0
    b5 = timed("d", alexnet_path, dev, card, report)
    timed("e", zoo_path, dev, card, report)
    report["vision_parts_s"] = parts
    wall = time.perf_counter() - t_phase
    report["vision_wall_s"] = wall
    log("phase 20 wall: %.1f s" % wall)
    return err, totals, serve, train, census, b5


# ------------------------------------------- object detection (phase 21)
DET = dict(rcnn_epochs=5, rcnn_k=4, ssd_epochs=4,
           ssd_batch=8, ssd_side=64, ssd_classes=3, seed=7,
           sgd={"learning_rate": 0.01, "momentum": 0.9, "wd": 5e-4},
           # B1's four sites at SSD's batch 8 (c2 and c3 share a shape)
           ssd_sites=(((8, 16, 64, 64), 1), ((8, 32, 32, 32), 2),
                      ((8, 64, 16, 16), 1)),
           # B5 at fc6: 2 images x 16 ROIs by 128 features
           fc6_shape=(32, 128))
RCNN_NAMES = dict(data_names=("data", "im_info", "gt_boxes"),
                  label_names=("rpn_label", "rpn_bbox_target",
                               "rpn_bbox_weight"))


def detection_graphs():
    """``tests/detection_graphs.py``: the two examples' graphs and loops
    spelled over a package argument (the examples import the JAX
    package)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import detection_graphs as dg
    return dg


def det_on_both(name, ins, dev, **kw):
    """The registry op on the card and on the CPU (the port's), same
    inputs -> (card outputs, CPU outputs) as numpy lists."""
    fn = mt.ops.registry.get(name).fn
    card = fn(*[torch.from_numpy(x).to(dev) for x in ins], **kw)
    cpu = fn(*[torch.from_numpy(x) for x in ins], **kw)
    torch.cuda.synchronize()
    card = card if isinstance(card, tuple) else (card,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    return [c.cpu().numpy() for c in card], [c.numpy() for c in cpu]


def det_same(what, got, want, sel=(), atol=1e-5):
    """``sel`` (column slices or callables) bitwise, every value within
    atol/rtol ``atol`` -> the max abs error; raises past it."""
    for s in sel:
        a, b = s(got), s(want)
        if not np.array_equal(a, b):
            raise RuntimeError("%s: the card's selections differ from the "
                               "CPU's (%d of %d)" % (what, int((a != b).sum()),
                                                     a.size))
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if not np.allclose(got, want, rtol=atol, atol=atol):
        raise RuntimeError("%s: max abs err %g past %g" % (what, err, atol))
    return err


def det_ops_check(dev):
    """Part a: every detection op on seeded inputs with ties, card against
    the port on the CPU: selections bitwise, values and the ROI ops'
    gradients within 1e-5 -> {op: max abs err}."""
    from mxnet_tpu_torch.ops import contrib_ops
    rng = np.random.RandomState(21)
    errs = {}
    n = 5120
    nms = np.zeros((2, n, 6), np.float32)
    nms[..., 0] = rng.randint(0, 3, (2, n))
    nms[..., 1] = np.round(rng.uniform(0, 1, (2, n)), 2)       # ties
    lo = rng.uniform(0, 0.8, (2, n, 2))
    nms[..., 2:4] = lo
    nms[..., 4:] = lo + rng.uniform(0.02, 0.2, (2, n, 2))
    for kw in (dict(), dict(id_index=0, topk=400)):
        (g,), (w,) = det_on_both("_contrib_box_nms", [nms], dev, **kw)
        errs["box_nms"] = det_same("box_nms %s" % kw, g, w,
                                   [lambda x: x], atol=0.0)
    x = np.round(rng.uniform(0, 1, (4, 12, 9)), 1).astype(np.float32)
    g, w = det_on_both("_contrib_bipartite_matching", [x], dev,
                       threshold=0.2)
    for a, b in zip(g, w):
        det_same("bipartite_matching", a, b, [lambda x: x], atol=0.0)
    errs["bipartite_matching"] = 0.0
    side = DET["ssd_side"]
    anchors = np.concatenate([mt.ops.registry.get(
        "_contrib_MultiBoxPrior").fn(torch.zeros(1, 1, s, s), sizes=sizes,
                                     ratios=(1.0, 2.0, 0.5)).numpy()
        for s, sizes in ((side // 2, (0.3, 0.39)), (side // 4, (0.6, 0.78)))],
        axis=1)
    (g,), (w,) = det_on_both("_contrib_MultiBoxPrior",
                             [np.zeros((1, 1, side // 2, side // 2),
                                       np.float32)], dev,
                             sizes=(0.3, 0.39), ratios=(1.0, 2.0, 0.5))
    errs["MultiBoxPrior"] = det_same("MultiBoxPrior", g, w)
    a = anchors.shape[1]
    label = np.full((8, 2, 5), -1.0, np.float32)
    for b in range(8):
        k = 1 + b % 2
        label[b, :k, 0] = rng.randint(0, 3, k)
        xy = rng.uniform(0.05, 0.5, (k, 2))
        label[b, :k, 1:3] = xy
        label[b, :k, 3:] = np.minimum(xy + rng.uniform(0.25, 0.45, (k, 2)),
                                      0.95)
    conf = rng.randn(8, 4, a).astype(np.float32)
    conf[:, :, :1000] = conf[:, :, :1]                     # tied backgrounds
    g, w = det_on_both("_contrib_MultiBoxTarget", [anchors, label, conf],
                       dev, negative_mining_ratio=3,
                       negative_mining_thresh=0.5, ignore_label=-1)
    det_same("MultiBoxTarget mask", g[1], w[1], [lambda x: x], atol=0.0)
    det_same("MultiBoxTarget classes", g[2], w[2], [lambda x: x], atol=0.0)
    errs["MultiBoxTarget"] = det_same("MultiBoxTarget offsets", g[0], w[0])
    e = np.exp(conf - conf.max(1, keepdims=True))
    prob = (e / e.sum(1, keepdims=True)).astype(np.float32)
    loc = (rng.randn(8, a * 4) * 0.3).astype(np.float32)
    (g,), (w,) = det_on_both("_contrib_MultiBoxDetection",
                             [prob, loc, anchors], dev, nms_topk=400)
    errs["MultiBoxDetection"] = det_same(
        "MultiBoxDetection", g, w, [lambda x: x[..., 0],
                                    lambda x: x[..., 1] >= 0])
    logits = rng.randn(2, 2, 3, 8, 8).astype(np.float32)
    logits[:, :, :, :3] = logits[:, :, :, :1]              # equal scores
    e = np.exp(logits - logits.max(1, keepdims=True))
    rprob = (e / e.sum(1, keepdims=True)).reshape(2, 6, 8, 8) \
        .astype(np.float32)
    deltas = (rng.randn(2, 12, 8, 8) * 0.2).astype(np.float32)
    info = np.array([[128, 128, 1], [128, 128, 1]], np.float32)
    g, w = det_on_both("_contrib_Proposal", [rprob, deltas, info], dev,
                       scales=(2, 4, 6), ratios=(1.0,), feature_stride=16,
                       rpn_pre_nms_top_n=64, rpn_post_nms_top_n=16,
                       threshold=0.7, rpn_min_size=8, output_score=True)
    errs["Proposal"] = det_same("Proposal", g[0], w[0],
                                [lambda x: x[:, 0], lambda x: x[:, 1] == -1],
                                atol=1e-4)
    feat = np.maximum(rng.randn(2, 64, 8, 8), 0).astype(np.float32)
    rois = np.concatenate([rng.randint(0, 2, (32, 1)),
                           rng.uniform(0, 60, (32, 2)),
                           rng.uniform(60, 127, (32, 2))], 1) \
        .astype(np.float32)
    cot = rng.randn(32, 64, 4, 4).astype(np.float32)
    for op in ("ROIPooling", "_contrib_ROIAlign"):
        res = []
        for d in (dev, torch.device("cpu")):
            f = torch.from_numpy(feat).to(d).requires_grad_(True)
            out = mt.ops.registry.get(op).fn(
                f, torch.from_numpy(rois).to(d), pooled_size=(4, 4),
                spatial_scale=1.0 / 16)
            (gr,) = torch.autograd.grad(
                (out * torch.from_numpy(cot).to(d)).sum(), [f])
            res.append((out.detach().cpu().numpy(), gr.cpu().numpy()))
        errs[op] = max(det_same(op, res[0][0], res[1][0]),
                       det_same(op + " gradient", res[0][1], res[1][1]))
    log("  (a) detection ops on the card vs the port on the CPU (ties "
        "planted; selections bitwise): max abs err %s; %d NMS walks on "
        "the host, %d bytes copied for them"
        % (json.dumps({k: float("%.3g" % v) for k, v in errs.items()}),
           contrib_ops.nms_passes, contrib_ops.nms_copy_bytes))
    return errs


def fit_profile(fit_once):
    """torch.profiler around ``fit_once()`` (one short fit, the card
    synchronized after) -> wall ms, device ms, busy share, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_once()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [(e.key, e.self_device_time_total, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(x[1] for x in kernels)
    if busy <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return {"wall_ms": wall_us / 1e3, "device_ms": busy / 1e3,
            "device_busy_share": busy / wall_us,
            "top_kernels": [{"name": x[0][:80], "ms": x[1] / 1e3,
                             "calls": x[2]}
                            for x in sorted(kernels, key=lambda x: -x[1])[:6]]}


def rcnn_module(P, ctx):
    return mt.mod.Module(P.rcnn_symbol(), context=ctx, **RCNN_NAMES)


def example_init(sym, shapes, seed):
    """The examples' ``mx.initializer.Xavier()`` as the JAX package draws
    it (uniform, "avg", magnitude 3, from numpy's global state after
    ``numpy.random.seed(seed)``, in the symbol's argument order; biases
    and betas 0, gammas 1, moving means 0 and variances 1), reproduced
    with numpy -> (arg params, aux params) as CPU tensors. At the
    R-CNN example's seed 7 these are its starting weights."""
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    np.random.seed(seed)
    args = {}
    for n, shp in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_weight"):
            hw = float(np.prod(shp[2:])) if len(shp) > 2 else 1.0
            fan = (shp[1] * hw + shp[0] * hw) / 2.0
            scale = np.sqrt(3.0 / fan)
            v = np.random.uniform(-scale, scale, shp)
        else:
            v = np.full(shp, 1.0 if n.endswith("_gamma") else 0.0)
        args[n] = torch.from_numpy(v.astype(np.float32))
    aux = {n: torch.full(tuple(shp), 1.0 if n.endswith("_var") else 0.0)
           for n, shp in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


def rcnn_first_step(dg, dev, p0):
    """Trouble spot: the first step, card against the CPU port, the CPU
    taking the card's ROIs and samples (its custom op replays the card's
    outputs) -> (outputs' worst relative L2, gradients' worst)."""
    rec, res = [], []
    for i, ctx in enumerate((mt.gpu(0), mt.cpu())):
        P = dg.rcnn_parts(mt)
        orig = P.ProposalTarget.forward

        def fwd(self, is_train, req, in_data, out_data, aux, _o=orig,
                _card=i == 0):
            if _card:
                _o(self, is_train, req, in_data, out_data, aux)
                rec.append([o.asnumpy() for o in out_data])
            else:
                for o, r, v in zip(out_data, req, rec[0]):
                    self.assign(o, r, v)
        P.ProposalTarget.forward = fwd
        it = P.RCNNIter(n=2, batch_size=2, seed=DET["seed"])
        with ctx:
            batch = next(it)
        sym = P.rcnn_symbol()
        shapes = dict(it.provide_data + it.provide_label)
        ex = sym.simple_bind(ctx, grad_req={n: "write" for n in p0},
                             **shapes)
        ex.copy_params_from({n: v for n, v in p0.items()})
        feed = dict(zip([n for n, _ in it.provide_data + it.provide_label],
                        list(batch.data) + list(batch.label)))
        outs = ex.forward(is_train=True, **{k: v.data for k, v in
                                            feed.items()})
        ex.backward()
        res.append(({j: o.detach().cpu() for j, o in enumerate(outs)},
                    {n: ex.grad_dict[n].detach().cpu() for n in p0}))
    (go, gg), (co, cg) = res
    out_err = max(rel_l2(go, co).values())
    grad_err = max(rel_l2(gg, cg).values())
    if out_err > 1e-4 or grad_err > 1e-3:
        raise RuntimeError("R-CNN's first step on the card vs the CPU (the "
                           "card's ROIs): outputs %g, gradients %g relative "
                           "L2" % (out_err, grad_err))
    return out_err, grad_err


def rcnn_path(dg, dev, card, report):
    """Part b: train_rcnn.py's fit at the example's settings (see the
    module docstring) -> (B5 launches, the per-step rows)."""
    from mxnet_tpu_torch.ops import contrib_ops, custom_op
    gpu = mt.gpu(0)
    P = dg.rcnn_parts(mt)
    it0 = P.RCNNIter(n=2, batch_size=2, seed=DET["seed"])
    p0, _ = example_init(P.rcnn_symbol(), dict(it0.provide_data
                                               + it0.provide_label),
                         DET["seed"])
    out_err, grad_err = rcnn_first_step(dg, dev, p0)
    log("  (b) R-CNN's first step on the card vs the CPU (the card's ROIs "
        "and samples replayed on the CPU): outputs within %.3g, gradients "
        "within %.3g relative L2" % (out_err, grad_err))
    runs = {}
    b5 = 0
    for label, k, epochs in (("auto", None, DET["rcnn_epochs"]),
                             ("k%d" % DET["rcnn_k"], DET["rcnn_k"], 1)):
        P = dg.rcnn_parts(mt)
        it = P.RCNNIter(batch_size=2, seed=DET["seed"])
        mod = rcnn_module(P, gpu)
        metric = P.RCNNMetric()
        losses, stamps = [], [time.perf_counter()]

        def epoch_cb(_e, _s, _a, _x, _m=metric, _l=losses, _t=stamps):
            torch.cuda.synchronize()
            _t.append(time.perf_counter())
            _l.append(float(_m.get()[1]))
        reset_all_counts()
        contrib_ops.reset_counts()
        custom_op.reset_counts()
        mod.fit(it, num_epoch=epochs, optimizer="sgd",
                optimizer_params=DET["sgd"],
                arg_params={n: v.clone() for n, v in p0.items()},
                aux_params={}, kvstore="local", eval_metric=metric,
                epoch_end_callback=epoch_cb, steps_per_dispatch=k)
        steps = epochs * (it.n // 2)
        counts = held_counts("R-CNN %s (B5 at fc6 each forward)" % label,
                             {"scale_bias_act": steps})
        b5 += counts["scale_bias_act"]
        fused = mod._fused
        if fused is None or fused.dispatch != "eager" or fused.captures:
            raise RuntimeError("R-CNN %s: the step must run uncaptured "
                               "(host ops %s)" % (label, getattr(
                                   fused, "host_ops", None)))
        if mod._fit_k != (k or 1):
            raise RuntimeError("R-CNN: fit ran at K %s" % mod._fit_k)
        if not np.isfinite(losses).all() or (
                len(losses) > 1 and not losses[-1] < losses[0]):
            raise RuntimeError("R-CNN %s: the loss did not fall: %s"
                               % (label, losses))
        step_ms = [float(x) * 1e3 / (it.n // 2) for x in np.diff(stamps)]
        runs[label] = {
            "k": mod._fit_k, "dispatch": fused.dispatch,
            "host_ops": list(fused.host_ops), "losses": losses,
            "step_ms_by_epoch": step_ms, "b5_launches": b5,
            "custom_round_trips": custom_op.round_trips,
            "custom_round_trip_us": custom_op.round_trip_us
            / max(custom_op.round_trips, 1),
            "custom_drain_us": custom_op.drain_us
            / max(custom_op.round_trips, 1),
            "nms_walks": contrib_ops.nms_passes,
            "nms_copy_bytes": contrib_ops.nms_copy_bytes}
        log("  R-CNN fit, K %s (%s, %s dispatch, host ops %s): losses %s; "
            "step wall by epoch %s ms; B5 launches %d (one a forward); "
            "Custom %d round trips, %.1f us each (copies and the op's "
            "Python) after %.1f us waiting for the queue; %d NMS walks, "
            "%d bytes copied  [%s]"
            % (mod._fit_k, label, fused.dispatch, list(fused.host_ops),
               ["%.4f" % x for x in losses], ["%.2f" % x for x in step_ms],
               counts["scale_bias_act"], custom_op.round_trips,
               runs[label]["custom_round_trip_us"],
               runs[label]["custom_drain_us"], contrib_ops.nms_passes,
               contrib_ops.nms_copy_bytes, card))
        if label == "auto":
            prof = fit_profile(lambda: mod.fit(
                P.RCNNIter(n=16, batch_size=2, seed=DET["seed"]),
                num_epoch=1, optimizer="sgd", optimizer_params=DET["sgd"],
                kvstore="local", eval_metric=P.RCNNMetric()))
            runs[label]["profile_8_steps"] = prof
            log("  R-CNN profiled over 8 steps: %.2f ms a step of wall, "
                "%.3f ms of device time, busy share %.3f; top kernels %s"
                % (prof["wall_ms"] / 8, prof["device_ms"] / 8,
                   prof["device_busy_share"],
                   [(t["name"][:40], round(t["ms"] / 8, 4))
                    for t in prof["top_kernels"][:4]]))
        del mod
    report["rcnn"] = {"first_step": {"outputs_rel_l2": out_err,
                                     "grads_rel_l2": grad_err},
                      "runs": runs}
    return b5


def ssd_path(dg, dev, card, report):
    """Part c: train_ssd.py's fit from the detection fixture through
    ``ImageDetIter`` on the card, then ``MultiBoxDetection`` over one
    batch -> (B1 launches in training, B1 launches in the detection
    forward)."""
    from mxnet_tpu_torch.kernels import nvjpeg
    from mxnet_tpu_torch.ops import contrib_ops
    import random as pyrandom
    gpu = mt.gpu(0)
    prefix = os.path.join(REPO, "build", "chip_smoke", "det")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    rec = dg.det_fixture().write_records(prefix, mt.recordio)
    B, side = DET["ssd_batch"], DET["ssd_side"]
    P = dg.ssd_parts(mt)
    pyrandom.seed(DET["seed"])
    mt.random.seed(DET["seed"])
    base = mt.image.ImageDetIter(batch_size=B, data_shape=(3, side, side),
                                 path_imgrec=rec, shuffle=True,
                                 rand_mirror=True, mean=True, std=True,
                                 ctx=gpu)
    it = mt.io.ResizeIter(base, size=max(1, 64 // B))
    mod = mt.mod.Module(P.ssd_symbol(DET["ssd_classes"]),
                        data_names=("data",), label_names=("label",),
                        context=gpu)
    metric = P.MultiBoxMetric()
    losses, stamps = [], [time.perf_counter()]

    def epoch_cb(_e, _s, _a, _x):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        losses.append(float(metric.get()[1]))
    reset_all_counts()
    decodes0 = nvjpeg.decodes
    args0, aux0 = example_init(mod.symbol, {"data": (B, 3, side, side),
                                            "label": (B,) + base.label_shape},
                               DET["seed"])
    mod.fit(it, num_epoch=DET["ssd_epochs"], optimizer="sgd",
            optimizer_params=DET["sgd"], arg_params=args0, aux_params=aux0,
            kvstore="tpu_sync", eval_metric=metric,
            batch_end_callback=mt.callback.Speedometer(B, 4),
            epoch_end_callback=epoch_cb)
    steps = DET["ssd_epochs"] * it.size
    counts = held_counts("SSD training (B1 at the four BatchNorm -> ReLU "
                         "sites each forward)", {"bn_act": 4 * steps})
    decoded = nvjpeg.decodes - decodes0
    if decoded != steps * B:
        raise RuntimeError("SSD: %d images decoded by nvJPEG, want %d"
                           % (decoded, steps * B))
    if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        raise RuntimeError("SSD: the loss did not fall: %s" % losses)
    wall = stamps[-1] - stamps[0]
    ep = [float(x) for x in np.diff(stamps)]
    log("  (c) SSD fit (ImageDetIter on the card, nvJPEG %d images; %d "
        "steps of %d): losses %s; %.1f images/s over the fit (decode "
        "included), epochs %s s; B1 launches %d (4 a forward); dispatch "
        "K %d  [%s]" % (decoded, steps, B, ["%.4f" % x for x in losses],
                        steps * B / wall, ["%.3f" % x for x in ep],
                        counts["bn_act"], mod._fit_k, card))
    # the detection forward over one batch: the trained weights, the
    # reference SSD's inference head
    args, aux = mod.get_params()
    it.reset()
    batch = next(it)
    base.close()
    dmod = mt.mod.Module(P.detect_symbol(DET["ssd_classes"]),
                         data_names=("data",), label_names=None,
                         context=gpu)
    dmod.bind(data_shapes=[("data", tuple(batch.data[0].shape))],
              for_training=False)
    dmod.init_params(arg_params=args, aux_params=aux)
    reset_all_counts()
    contrib_ops.reset_counts()
    dmod.forward(batch, is_train=False)
    det, prob, loc, anc = dmod.get_outputs()
    torch.cuda.synchronize()
    dcounts = held_counts("SSD detection forward", {"bn_act": 4})
    nms_bytes = contrib_ops.nms_copy_bytes
    cpu_det = mt.ops.registry.get("_contrib_MultiBoxDetection").fn(
        prob.cpu(), loc.cpu(), anc.cpu(), nms_threshold=0.5,
        force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400)
    got = det.cpu().numpy()
    err = det_same("SSD MultiBoxDetection (card vs CPU, the card's "
                   "probabilities)", got, cpu_det.numpy(),
                   [lambda x: x[..., 0], lambda x: x[..., 1] >= 0])
    if got.shape != (B, 5120, 6) or not (got[..., 0] >= 0).any():
        raise RuntimeError("SSD detections: shape %s, %d kept"
                           % (got.shape, int((got[..., 0] >= 0).sum())))

    def detect():
        mt.ops.registry.get("_contrib_MultiBoxDetection").fn(
            prob, loc, anc, nms_threshold=0.5, force_suppress=False,
            variances=(0.1, 0.1, 0.2, 0.2), nms_topk=400)
        torch.cuda.synchronize()
    detect()
    t0 = time.perf_counter()
    for _ in range(3):
        detect()
    det_ms = (time.perf_counter() - t0) / 3 * 1e3
    kept = int((got[..., 0] >= 0).sum())
    log("  SSD MultiBoxDetection over one batch (8 x 5120 anchors): %d "
        "detections kept, selections bitwise the CPU's on the card's "
        "probabilities, values within %.3g; %.2f ms of host wall a call "
        "(IoU on the card, %d bytes of packed suppression bits copied, "
        "the greedy walk on the host); B1 launches %d  [%s]"
        % (kept, err, det_ms, nms_bytes, dcounts["bn_act"], card))
    report["ssd"] = {"losses": losses, "epoch_s": ep,
                     "images_per_s": steps * B / wall,
                     "b1_launches": counts["bn_act"],
                     "detect": {"kept": kept, "max_abs_err": err,
                                "ms": det_ms, "nms_copy_bytes": nms_bytes,
                                "b1_launches": dcounts["bn_act"]}}
    del mod, dmod
    return counts["bn_act"], dcounts["bn_act"]


def detection_path(dev, card, report):
    """Phase 21 (see the module docstring) -> (the detection ops' errors,
    B1's SSD rows and totals, B1 launches trained and in detection, B5's
    row at R-CNN's fc6 with its launches)."""
    t_phase = time.perf_counter()
    log("phase 21: object detection (train_rcnn.py's Faster R-CNN with its "
        "Custom op, train_ssd.py's SSD through ImageDetIter on the card, "
        "MultiBoxDetection)")
    dg = detection_graphs()
    errs = det_ops_check(dev)
    rows = [b1_class_row("bn_act", shape, torch.float32, sites, dev, 31,
                         "SSD ") for shape, sites in DET["ssd_sites"]]
    b1_tot = b1_totals(rows, "B1 over SSD's 4 sites (batch 8, f32)")
    b1_err = max(r["max_abs_err"] for r in rows)
    b5 = b5_row(DET["fc6_shape"], torch.float32, dev, "R-CNN's fc6")
    b5["launches"] = rcnn_path(dg, dev, card, report)
    b1_train, b1_detect = ssd_path(dg, dev, card, report)
    released(dev)
    wall = time.perf_counter() - t_phase
    report["detection"] = {"ops_max_abs_err": errs, "b1_rows": rows,
                           "b1_totals": b1_tot, "b5": b5, "wall_s": wall}
    log("phase 21 wall: %.1f s" % wall)
    return errs, b1_err, b1_tot, b1_train, b1_detect, b5


# --------------------------- the common ops and the optimizers (phase 22)
EX = dict(sr=dict(n=128, size=32, factor=2, batch=16, epochs=6, lr=1e-3),
          mnist=dict(batch=64, epochs=5,
                     sgd={"learning_rate": 0.1, "momentum": 0.9}),
          cifar=dict(batch=128, epochs=10, lr_step_epochs=(200, 250),
                     sgd={"learning_rate": 0.05, "momentum": 0.9,
                          "wd": 1e-4, "multi_precision": True}),
          opt=dict(batch=16, steps=3, lr=0.01),
          # B5 at train_mnist.py's fc1 and fc2 (batch 64)
          mnist_b5=((64, 128), (64, 64)))
# the ten optimizers of this slice, each with its momentum where it takes
# one; a card weight farther from the CPU's replay than OPT_LIMIT of the
# largest update fails
NEW_OPTIMIZERS = {"nag": {"momentum": 0.9}, "adadelta": {}, "rmsprop": {},
                  "ftrl": {}, "signum": {}, "signsgd": {}, "ftml": {},
                  "nadam": {}, "dcasgd": {"momentum": 0.9},
                  "lbsgd": {"momentum": 0.9}}
OPT_LIMIT = 1e-4
# the witness of part d: one training step of ResNet-20 at batch 16 in
# f64 on the CPU; every f32 path's outputs within WITNESS_OUT of it and
# its gradients within WITNESS_GRAD (relative L2, the worst parameter:
# ReLU masks that flip at pre-activations of rounding size move a
# parameter's gradient by ~1 %, a fault by far more); every flip of the
# CPU's fused path at a pre-activation below WITNESS_PRE
WITNESS_OUT, WITNESS_GRAD, WITNESS_PRE = 1e-5, 5e-2, 1e-4
TRANS_TOL = dict(rtol=1e-5, atol=1e-6)
SUM_TOL = dict(rtol=1e-5, atol=1e-4)     # sums over 96 terms of size ~3
# the update ops: ftrl's z - sign(z) * lamda1 and rmspropalex's n - g^2
# cancel, which magnifies a contracted FMA's rounding on the card
UPDATE_TOL = dict(rtol=1e-5, atol=1e-4)


def example_nets():
    """``tests/example_nets.py``: the examples of BASELINE configurations
    1 and 3 spelled over a package argument (the examples import the JAX
    package)."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import example_nets as en
    return en


def sr_first_step(en, lo, hi, dev):
    """One step's forward and backward of the ESPCN net on the card and
    on the CPU from the same Orthogonal weights -> (the outputs' max abs
    error, the gradients' worst relative L2 error)."""
    res = {}
    for where in ("cpu", "card"):
        ctx = mt.cpu() if where == "cpu" else mt.gpu(0)
        net = en.sr_net(mt.gluon, EX["sr"]["factor"], prefix="sr_")
        net.initialize(mt.init.Orthogonal(), ctx=ctx)
        net.hybridize(static_alloc=True)
        x = mt.nd.array(lo[:EX["sr"]["batch"]], ctx=ctx)
        y = mt.nd.array(hi[:EX["sr"]["batch"]], ctx=ctx)
        with mt.autograd.record():
            out = net(x)
            loss = mt.gluon.loss.L2Loss()(out, y)
        loss.backward()
        res[where] = (out.asnumpy(), {
            k: torch.from_numpy(p.grad().asnumpy())
            for k, p in net.collect_params().items()})
    out_err = float(np.abs(res["card"][0] - res["cpu"][0]).max())
    grad_err = max(rel_l2(res["card"][1], res["cpu"][1]).values())
    if out_err > 1e-4 or grad_err > 1e-3:
        raise RuntimeError("super_resolution first step: outputs %.3g, "
                           "gradients %.3g relative from the CPU's"
                           % (out_err, grad_err))
    return out_err, grad_err


def super_resolution_path(en, dev, card, report):
    """Part a: ``examples/super_resolution.py`` at its defaults through
    ``mt`` -> PSNR by epoch."""
    P = EX["sr"]
    lo, hi = en.synthetic_pairs(n=P["n"], size=P["size"], factor=P["factor"])
    out_err, grad_err = sr_first_step(en, lo, hi, dev)
    log("  super_resolution.py's first step on the card vs the CPU from the "
        "same Orthogonal weights: outputs within %.3g, gradients %.3g "
        "relative L2" % (out_err, grad_err))
    ctx = mt.gpu(0)
    np.random.seed(0)
    it = mt.io.NDArrayIter(lo, hi, batch_size=P["batch"], shuffle=True,
                           label_name="label")
    net = en.sr_net(mt.gluon, P["factor"])
    net.initialize(mt.init.Orthogonal(), ctx=ctx)
    net.hybridize(static_alloc=True)
    loss_fn = mt.gluon.loss.L2Loss()
    trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": P["lr"]})

    def step(batch):
        x = batch.data[0].as_in_context(ctx)
        y = batch.label[0].as_in_context(ctx)
        with mt.autograd.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        trainer.step(x.shape[0])

    # the main path: every count zeroed just before, read just after
    reset_all_counts()
    tier.reset_stats()
    psnrs, walls = [], []
    for _ in range(P["epochs"]):
        it.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in it:
            step(batch)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        pred = net(mt.nd.array(lo[:16], ctx=ctx)).asnumpy()
        psnrs.append(en.psnr(pred, hi[:16]))
    held_counts("super_resolution.py (no kernel on its path)", {})
    if not psnrs[-1] > psnrs[0]:
        raise RuntimeError("super_resolution PSNR did not rise: %s" % psnrs)
    it.reset()
    batches = [b for _, b in zip(range(4), it)]
    prof = fit_profile(lambda: [step(b) for b in batches])
    img_s = P["n"] / float(np.median(walls[1:]))
    log("  super_resolution.py, %d epochs of %d images at batch %d: PSNR %s "
        "dB; epoch wall %s s, %.1f images/s (median past the first epoch); "
        "4 profiled steps %.2f ms wall, busy share %.3f; no kernel launched, "
        "no fallback  [%s]"
        % (P["epochs"], P["n"], P["batch"], ["%.2f" % v for v in psnrs],
           ["%.3f" % w for w in walls], img_s, prof["wall_ms"],
           prof["device_busy_share"], card))
    report["super_resolution"] = {
        "first_step": {"out_max_abs_err": out_err, "grad_rel_l2": grad_err},
        "psnr_db": psnrs, "epoch_wall_s": walls, "img_per_s": img_s,
        "profile": prof}


def score_acc(mod, it):
    it.reset()
    return dict(mod.score(it, "acc"))["accuracy"]


def mnist_path(en, dev, card, report):
    """Part b: ``examples/train_mnist.py`` at its defaults -> (B5 rows at
    fc1 and fc2 with the run's launches)."""
    P = EX["mnist"]
    Xt, yt, Xv, yv = en.mnist_data()
    sym = en.mlp_symbol(mt.sym)
    with mt.config.override(kernel_tier="auto"):
        per_fwd = mt.serving._kernel_census(sym).get("fc_act", 0)
    if per_fwd != 2:
        raise RuntimeError("train_mnist's fusion plan routes %d fc_act "
                           "sites, not 2 (fc1, fc2)" % per_fwd)
    rows = [b5_row(s, torch.float32, dev, "train_mnist.py's fc%d" % (i + 1))
            for i, s in enumerate(EX["mnist_b5"])]
    np.random.seed(0)
    train = mt.io.NDArrayIter(Xt, yt, P["batch"], shuffle=True)
    val = mt.io.NDArrayIter(Xv, yv, P["batch"])
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(mt.init.Xavier())
    acc0 = score_acc(mod, val)
    accs = []
    catcher = LineCatcher()
    logging.getLogger().addHandler(catcher)
    level = logging.getLogger().level
    logging.getLogger().setLevel(logging.INFO)
    reset_all_counts()
    tier.reset_stats()
    t0 = time.perf_counter()
    try:
        mod.fit(train, eval_data=val, num_epoch=P["epochs"], kvstore="local",
                optimizer="sgd", optimizer_params=dict(P["sgd"]),
                initializer=mt.init.Xavier(),
                batch_end_callback=mt.callback.Speedometer(P["batch"], 50),
                eval_end_callback=lambda p: accs.append(
                    dict(p.eval_metric.get_name_value())["accuracy"]))
        torch.cuda.synchronize()
    finally:
        logging.getLogger().removeHandler(catcher)
        logging.getLogger().setLevel(level)
    wall = time.perf_counter() - t0
    fwd = P["epochs"] * (train.num_batches + val.num_batches)
    counts = held_counts("train_mnist.py (B5 at fc1 and fc2 each forward)",
                         {"scale_bias_act": per_fwd * fwd})
    if mod._fused is None:
        raise RuntimeError("train_mnist on the card ran without the fused "
                           "step")
    if not accs[-1] > acc0:
        raise RuntimeError("train_mnist accuracy did not rise: %.4f -> %s"
                           % (acc0, accs))
    for r in rows:
        r["launches"] = counts["scale_bias_act"] // per_fwd
    log("  train_mnist.py, %d epochs at batch %d (kvstore local, SGD lr 0.1 "
        "momentum 0.9): validation accuracy %.4f before, %s by epoch; "
        "%.1f images/s over the fit (eval included); B5 launches %d (%d a "
        "forward over %d forwards), no fallback  [%s]"
        % (P["epochs"], P["batch"], acc0, ["%.4f" % a for a in accs],
           P["epochs"] * len(Xt) / wall, counts["scale_bias_act"], per_fwd,
           fwd, card))
    for ln in catcher.lines:
        if "Speed" in ln and "Batch [50]" in ln:
            log("    " + ln)
    report["mnist"] = {"acc_before": acc0, "acc": accs, "wall_s": wall,
                       "b5_rows": rows, "launches": counts}
    return rows


def cifar_b1_rows(sym, dev):
    """B1 at ResNet-20's site classes (bf16, batch 128) against its plain
    version, timed beside its bound -> (rows, totals)."""
    classes = {}
    for form, chw in planned_sites(sym, (3, 28, 28)):
        classes[(form, chw)] = classes.get((form, chw), 0) + 1
    rows = [b1_class_row(form, (EX["cifar"]["batch"],) + chw,
                         torch.bfloat16, n, dev, 41, "ResNet-20 ")
            for (form, chw), n in sorted(classes.items())]
    tot = {}
    for form in ("bn_act", "bn_act_res"):
        mine = [r for r in rows if r["form"] == form]
        tot[form] = b1_totals(mine, "B1 %s over ResNet-20's sites (batch "
                              "128, bf16)" % form)
    return rows, tot


def cifar_path(en, dev, card, report):
    """Part c: ``examples/train_cifar10.py`` at its defaults -> (B1
    launches by form, B1 rows, totals, the worst error)."""
    P = EX["cifar"]
    Xt, yt, Xv, yv = en.cifar_data()
    sym = mt.models.resnet_symbol(num_classes=10, num_layers=20,
                                  image_shape=(3, 28, 28))
    with mt.config.override(kernel_tier="auto"):
        census = mt.serving._kernel_census(sym)
    rows, tot = cifar_b1_rows(sym, dev)
    np.random.seed(0)
    train = mt.io.NDArrayIter(Xt, yt, P["batch"], shuffle=True)
    val = mt.io.NDArrayIter(Xv, yv, P["batch"])
    steps = [e * train.num_batches for e in P["lr_step_epochs"]]
    sgd = dict(P["sgd"], lr_scheduler=mt.lr_scheduler.MultiFactorScheduler(
        step=steps, factor=0.1))
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(train.provide_data, train.provide_label)
    mod.init_params(mt.init.Xavier(factor_type="in", magnitude=2.0))
    acc0 = score_acc(mod, val)
    prefix = os.path.join(REPO, "build", "chip_smoke", "cifar10", "resnet20")
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    accs, stamps, saved = [], [], []

    def epoch_cb(epoch, s, arg, aux):
        mt.model.save_checkpoint(prefix, epoch + 1, s, arg, aux)
        saved.append(epoch + 1)

    reset_all_counts()
    tier.reset_stats()
    t0 = time.perf_counter()
    mod.fit(train, eval_data=val, num_epoch=P["epochs"], eval_metric="acc",
            optimizer="sgd", optimizer_params=sgd,
            initializer=mt.init.Xavier(factor_type="in", magnitude=2.0),
            kvstore="tpu_sync", epoch_end_callback=epoch_cb,
            eval_end_callback=lambda p: accs.append(
                dict(p.eval_metric.get_name_value())["accuracy"]),
            batch_end_callback=[mt.callback.Speedometer(P["batch"], 50),
                                lambda p: stamps.append(time.perf_counter())])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd = P["epochs"] * (train.num_batches + val.num_batches)
    want = {k: n * fwd for k, n in census.items()}
    counts = held_counts("train_cifar10.py (B1 at ResNet-20's %s sites each "
                         "forward)" % census, want)
    fused = mod._fused
    if fused is None or fused.compute_dtype != torch.bfloat16:
        raise RuntimeError("train_cifar10: fused step %s" % fused)
    if not accs[-1] > acc0:
        raise RuntimeError("train_cifar10 validation accuracy did not rise: "
                           "%.4f -> %s" % (acc0, accs))
    _, arg, _ = mt.model.load_checkpoint(prefix, P["epochs"], ctx=mt.cpu())
    now, _ = mod.get_params()
    if saved != list(range(1, P["epochs"] + 1)) or any(
            not torch.equal(arg[k].data, now[k].cpu()) for k in now):
        raise RuntimeError("train_cifar10: the last checkpoint is not the "
                           "trained weights (saved %s)" % saved)
    per_epoch = train.num_batches
    step_ms = [d * 1e3 for e in range(P["epochs"])
               for d in np.diff(stamps[e * per_epoch:(e + 1) * per_epoch])]
    p50 = float(np.median(step_ms))
    log("  train_cifar10.py, ResNet-20 at batch %d, %d epochs (tpu_sync, "
        "bf16 over f32 masters, MultiFactorScheduler): validation accuracy "
        "%.4f before, %s by epoch; step p50 %.2f ms (host stamps at batch "
        "end within an epoch), %.1f images/s; fit wall %.1f s (eval and "
        "checkpoints included); B1 launches %s, %s a forward over %d "
        "forwards, no fallback  [%s]"
        % (P["batch"], P["epochs"], acc0, ["%.4f" % a for a in accs], p50,
           P["batch"] / (p50 / 1e3), wall, {k: counts[k] for k in census},
           census, fwd, card))
    report["cifar10"] = {"acc_before": acc0, "acc": accs,
                         "step_ms_p50": p50,
                         "img_per_s": P["batch"] / (p50 / 1e3),
                         "wall_s": wall, "census": census,
                         "b1_rows": rows, "b1_totals": tot,
                         "launches": counts}
    return ({k: counts.get(k, 0) for k in ("bn_act", "bn_act_res")}, rows,
            tot, max(r["max_abs_err"] for r in rows))


def optimizer_fit(sym, name, X, Y, p0, aux0):
    """``Module.fit`` on the card, 3 steps with optimizer ``name``
    (kvstore ``local``: its fused form where it has one, else the eager
    Updater) -> (module, the gradients each update received, in order:
    per fused step {name: grad}, per eager call (index, grad))."""
    from mxnet_tpu_torch.module.fused import FusedStep
    records = []
    fused_apply, eager_call = FusedStep._apply, mt.optimizer.Updater.__call__

    def apply(self, grads, opt_state, hyp):
        records.append({k: grads[k].detach().clone()
                        for k in self.param_names})
        return fused_apply(self, grads, opt_state, hyp)

    def call(self, index, grad, weight):
        records.append((index, grad.detach().clone()))
        return eager_call(self, index, grad, weight)

    FusedStep._apply, mt.optimizer.Updater.__call__ = apply, call
    try:
        mod = mt.mod.Module(sym, context=mt.gpu(0))
        mod.fit(mt.io.NDArrayIter(X, Y, EX["opt"]["batch"]), num_epoch=1,
                kvstore="local", optimizer=name,
                optimizer_params=dict(NEW_OPTIMIZERS.get(
                    name, {"momentum": 0.9}), learning_rate=EX["opt"]["lr"]),
                arg_params={k: v.clone() for k, v in p0.items()},
                aux_params={k: v.clone() for k, v in aux0.items()},
                initializer=None, eval_metric=None, steps_per_dispatch=1)
        torch.cuda.synchronize()
    finally:
        FusedStep._apply, mt.optimizer.Updater.__call__ = fused_apply, \
            eager_call
    return mod, records


def optimizer_replay(mod, name, records, p0):
    """The same updates on the CPU: the port's optimizer, made as
    ``Module.init_optimizer`` makes it, applies the card's own gradients
    to the starting weights in the card's order -> {name: weight}."""
    names = list(mod._param_names)
    idx = {n: i for i, n in enumerate(names)}
    opt = mt.optimizer.create(
        name, rescale_grad=1.0 / EX["opt"]["batch"],
        param_idx2name=dict(enumerate(names)),
        learning_rate=EX["opt"]["lr"],
        **NEW_OPTIMIZERS.get(name, {"momentum": 0.9}))
    upd = mt.optimizer.get_updater(opt)
    w = {n: p0[n].clone() for n in names}
    for rec in records:
        if isinstance(rec, dict):
            for n in mod._fused.param_names:
                upd(idx[n], rec[n].cpu(), w[n])
        else:
            upd(rec[0], rec[1].cpu(), w[names[rec[0]]])
    return w


def witness_step(sym, X, Y, p0, aux0, device, dtype, kernel_tier):
    """One training forward and backward of ``sym`` at ``p0`` through an
    executor -> (outputs, {name: gradient}, [pre-activation of every ReLU
    site in graph order]), all f64 on the CPU. The pre-activations are
    read on the CPU only: the Activation op's input, or at a fused site
    the unfused formula's value on the fused op's inputs."""
    pre = []
    act = mt.ops.registry.get("Activation")
    act_fn, bn_fwd = act.fn, bn_act._BnAct.forward

    def spy_act(data, **kw):
        pre.append(data.detach().double().clone())
        return act_fn(data, **kw)

    def spy_bn(ctx, data, gamma, beta, mm, mv, residual, kw, act_t, cfg):
        with torch.no_grad():
            pre.append(bn_act._reference(data, gamma, beta, mm, mv,
                                         residual, None, **kw).double())
        return bn_fwd(ctx, data, gamma, beta, mm, mv, residual, kw, act_t,
                      cfg)

    ctx = mt.cpu() if device == "cpu" else mt.gpu(0)
    put = lambda t: mt.nd.NDArray(t.to(device, dtype), ctx=ctx)  # noqa
    args = {k: put(v) for k, v in p0.items()}
    args["data"], args["softmax_label"] = put(X), put(Y)
    if device == "cpu":
        act.fn, bn_act._BnAct.forward = spy_act, staticmethod(spy_bn)
    try:
        with mt.config.override(kernel_tier=kernel_tier):
            ex = sym.bind(ctx, args, args_grad={
                k: put(torch.zeros_like(v)) for k, v in p0.items()},
                aux_states={k: put(v) for k, v in aux0.items()})
            out = ex.forward(is_train=True)[0]
            ex.backward()
    finally:
        act.fn, bn_act._BnAct.forward = act_fn, bn_fwd
    as64 = lambda t: (t._data if hasattr(t, "_data") else t).detach() \
        .to("cpu", torch.float64)  # noqa
    return (as64(out), {k: as64(ex.grad_dict[k]) for k in p0}, pre)


def gradient_witness(sym, X, Y, p0, aux0, dev):
    """Part d's witness: one step's outputs and gradients of the card's
    f32 paths (tier auto, as ``Module.fit`` runs, and off) and the CPU's
    (auto and off) against the CPU's f64 step (no site is fused in f64)
    -> {path: (out err, worst relative L2 gradient error, ReLU flips)}.
    Flips are counted where the CPU saw the pre-activations."""
    X, Y = torch.from_numpy(X), torch.from_numpy(Y)
    ref_out, ref_g, ref_pre = witness_step(sym, X, Y, p0, aux0, "cpu",
                                           torch.float64, "off")
    rows = {}
    for device, kt in (("cpu", "off"), ("cpu", "auto"), (dev, "off"),
                       (dev, "auto")):
        out, g, pre = witness_step(sym, X, Y, p0, aux0, device,
                                   torch.float32, kt)
        o_err = float((out - ref_out).abs().max())
        g_err = max(float((g[k] - ref_g[k]).norm()
                          / ref_g[k].norm().clamp_min(1e-30)) for k in g)
        flips, worst_pre = 0, 0.0
        for a, b in zip(pre, ref_pre):
            f = (a > 0) != (b > 0)
            flips += int(f.sum())
            if f.any():
                worst_pre = max(worst_pre, float(b[f].abs().max()))
        name = "%s/%s" % ("cpu" if device == "cpu" else "card", kt)
        rows[name] = (o_err, g_err, flips if pre else None)
        log("  witness %-9s one step of ResNet-20 at batch 16 against the "
            "CPU's f64: outputs within %.3g, gradients within %.3g "
            "(worst parameter, relative L2)%s"
            % (name, o_err, g_err, "" if not pre else
               "; %d ReLU flips, the largest at |pre| %.3g"
               % (flips, worst_pre)))
        if not (o_err <= WITNESS_OUT and g_err <= WITNESS_GRAD
                and worst_pre <= WITNESS_PRE):
            raise RuntimeError("witness %s: outputs %.3g, gradients %.3g, "
                               "a flip at |pre| %.3g from the f64 step"
                               % (name, o_err, g_err, worst_pre))
    return rows


def optimizers_path(en, dev, card, report):
    """Part d: each new optimizer, and SGD with momentum beside them, 3
    steps of ResNet-20 at batch 16 through ``Module.fit`` on the card,
    then the same optimizer on the CPU applying the card's own gradients
    in the card's order -> {name: the largest distance of a card weight
    from the CPU's, over the largest update}. Before them the witness
    holds the first step's outputs and gradients, card and CPU, against
    the CPU's f64 step: a ReLU mask that flips at a pre-activation of
    rounding size moves some parameter's gradient by ~1 % at this batch,
    so two whole f32 runs on two devices are compared through f64, not
    with each other."""
    sym = mt.models.resnet_symbol(num_classes=10, num_layers=20,
                                  image_shape=(3, 28, 28))
    Xt, yt, _, _ = en.cifar_data()
    n = EX["opt"]["batch"] * EX["opt"]["steps"]
    X, Y = Xt[:n], yt[:n]
    p0, aux0 = resnet_init(sym, dev, (3, 28, 28))
    b = EX["opt"]["batch"]
    witness = gradient_witness(sym, X[:b], Y[:b], p0, aux0, dev)
    errs = {}
    tier.reset_stats()
    for name in ("sgd",) + tuple(NEW_OPTIMIZERS):
        mod, records = optimizer_fit(sym, name, X, Y, p0, aux0)
        want = optimizer_replay(mod, name, records, p0)
        got, _ = mod.get_params()
        step = max(float((want[k] - p0[k]).abs().max()) for k in want)
        diff = max(float((got[k].cpu() - want[k]).abs().max())
                   for k in want)
        errs[name] = diff / max(step, 1e-30)
        if mod._fused is not None:
            n_upd = len(records)
        else:
            n_upd = len(records) // len(want)
        log("  %-8s 3 steps of ResNet-20 (batch 16, lr 0.01, %s), %s on the "
            "card: its weights within %.3g of the CPU's replay of the card's "
            "gradients (max abs error over the largest update, %.3g); %d "
            "updates"
            % (name, NEW_OPTIMIZERS.get(name, {"momentum": 0.9})
               or "defaults", "fused" if mod._fused is not None
               else "eager", errs[name], step, n_upd))
        if n_upd != EX["opt"]["steps"] or not errs[name] <= OPT_LIMIT:
            raise RuntimeError("optimizer %s on the card: %d updates, weights "
                               "%.3g from the CPU's replay"
                               % (name, n_upd, errs[name]))
    if tier.stats()["fallback"]:
        raise RuntimeError("optimizers: tier fallback %s"
                           % tier.stats()["fallback"])
    report["optimizers"] = errs
    report["optimizer_witness"] = witness
    return errs


def op_cases():
    """(name, inputs, params, tolerance) for the new op families: None
    is bitwise."""
    rng = np.random.RandomState(0)
    f = rng.uniform(-3, 3, (64, 96)).astype(np.float32)
    pos = rng.uniform(0.1, 5, (64, 96)).astype(np.float32)
    unit = rng.uniform(-0.99, 0.99, (64, 96)).astype(np.float32)
    ties = np.round(f * 2).astype(np.float32)
    i32 = rng.randint(-20, 20, (64, 96)).astype(np.int32)
    idx = rng.randint(-70, 70, (2, 500)).astype(np.int32)
    cases = [(n, [f], {}, None) for n in (
        "sign", "rint", "round", "ceil", "floor", "trunc", "fix",
        "logical_not", "softsign", "degrees", "reciprocal")]
    cases += [(n, [pos], {}, TRANS_TOL) for n in (
        "rsqrt", "cbrt", "rcbrt", "log10", "log2", "log1p", "expm1", "sin",
        "cos", "arctan", "sinh", "cosh", "arcsinh", "erf", "gammaln",
        "gamma")]
    cases += [(n, [unit], {}, TRANS_TOL) for n in (
        "arcsin", "arccos", "arctanh", "erfinv", "tan")]
    cases += [("arccosh", [pos + 1], {}, TRANS_TOL),
              ("broadcast_hypot", [f, f[:1]], {}, TRANS_TOL)]
    cases += [(n, [i32, np.where(i32[:1] == 0, 7, i32[:1])], {}, None)
              for n in ("broadcast_mod", "broadcast_logical_and",
                        "broadcast_logical_or", "broadcast_logical_xor")]
    cases += [("_mod", [f, np.where(f == 0, 1, f)[::-1].copy()], {}, None),
              ("_mod_scalar", [f], {"scalar": -1.5}, None),
              ("_rmod_scalar", [pos], {"scalar": 2.5}, None),
              ("_maximum_scalar", [f], {"scalar": 0.5}, None),
              ("add_n", [f, pos, unit], {}, None),
              ("argmax", [ties], {"axis": 1}, None),
              ("argmin", [ties], {"axis": 0}, None),
              ("sort", [ties], {"is_ascend": False}, None),
              ("argsort", [ties], {}, None),
              ("topk", [ties], {"k": 7, "ret_typ": "both"}, None),
              ("topk", [ties], {"k": 7, "ret_typ": "mask",
                                "is_ascend": True}, None),
              ("cumsum", [f], {"axis": 1}, SUM_TOL),
              ("nansum", [np.where(f > 2, np.nan, f)], {"axis": 0},
               SUM_TOL),
              ("square_sum", [f], {"axis": 1}, SUM_TOL),
              ("slice", [f], {"begin": (3, None), "end": (50, 5),
                              "step": (2, -3)}, None),
              ("tile", [f[:8]], {"reps": (2, 3)}, None),
              ("repeat", [f], {"repeats": 2, "axis": 0}, None),
              ("flip", [f], {"axis": (0, 1)}, None),
              ("take", [f, idx[0].astype(np.float32)], {"axis": 1}, None),
              ("gather_nd", [f, idx], {}, None),
              ("scatter_nd", [f[0, :50], np.stack([
                  np.arange(50) % 64, np.arange(50) * 7 % 96])
                  .astype(np.int32)], {"shape": (64, 96)}, None),
              ("one_hot", [idx[0]], {"depth": 50}, None),
              ("batch_take", [f, idx[0, :64].copy()], {}, None),
              ("depth_to_space", [f.reshape(2, 48, 8, 8)],
               {"block_size": 2}, None),
              ("space_to_depth", [f.reshape(2, 12, 16, 16)],
               {"block_size": 4}, None),
              ("diag", [f], {"k": 2}, None),
              ("khatri_rao", [f[:4, :6], pos[:5, :6]], {}, None),
              ("histogram", [f], {"bin_cnt": 17, "range": (-2.0, 2.5)},
               None),
              ("_unravel_index", [idx[0] * 40], {"shape": (64, 96)}, None),
              ("_ravel_multi_index", [idx], {"shape": (64, 96)}, None),
              ("_slice_assign", [f, pos[:20, :10]],
               {"begin": (40, 5), "end": (0, 15), "step": (-2, 1)}, None),
              ("_sparse_retain", [f, idx[0, :9].copy()], {}, None),
              ("_eye", [], {"N": 64, "M": 96, "k": -3}, None),
              ("_linspace", [], {"start": -1.0, "stop": 3.0, "num": 500},
               TRANS_TOL),
              ("_sample_unique_zipfian", [], {"range_max": 50,
                                              "shape": (16, 40)}, None)]
    w, g = f, unit
    st = [np.abs(pos), np.abs(pos[::-1]).copy(), np.abs(f)]
    clip = {"rescale_grad": 0.5, "clip_gradient": 0.8}
    cases += [
        ("sgd_update", [w, g], dict(clip, lr=0.1, wd=0.01), UPDATE_TOL),
        ("sgd_mom_update", [w, g, st[0]], dict(clip, lr=0.1, momentum=0.9),
         UPDATE_TOL),
        ("nag_mom_update", [w, g, st[0]], dict(clip, lr=0.1, momentum=0.9),
         UPDATE_TOL),
        ("adam_update", [w, g, st[0], st[1]], dict(clip, lr=0.01),
         UPDATE_TOL),
        ("rmsprop_update", [w, g, st[0]], dict(clip, lr=0.01), UPDATE_TOL),
        ("rmspropalex_update", [w, g, st[0], st[1] * 0.01, st[2]],
         dict(clip, lr=0.01), UPDATE_TOL),
        ("ftrl_update", [w, g, st[0], st[1]], dict(clip, lr=0.1),
         UPDATE_TOL),
        ("signsgd_update", [w, g], dict(clip, lr=0.1, wd=0.01), UPDATE_TOL),
        ("signum_update", [w, g, st[0]], dict(clip, lr=0.1, momentum=0.9),
         UPDATE_TOL),
        ("adagrad_update", [w, g, st[0]], dict(clip, lr=0.1), UPDATE_TOL),
        ("_sparse_adagrad_update", [w, g, st[0]], dict(clip, lr=0.1),
         UPDATE_TOL),
        ("adadelta_update", [w, g, st[0], st[1]], dict(clip), UPDATE_TOL),
        ("ftml_update", [w, g, st[0], st[1], st[2]],
         dict(rescale_grad=0.5, clip_grad=0.8, lr=0.01, t=3), UPDATE_TOL),
        ("mp_sgd_update", [w.astype(np.float16), g.astype(np.float16), w],
         dict(clip, lr=0.1), UPDATE_TOL),
        ("mp_sgd_mom_update", [w.astype(np.float16), g.astype(np.float16),
                               st[0], w], dict(clip, lr=0.1, momentum=0.9),
         UPDATE_TOL),
        ("group_adagrad_update", [w, g, st[0][:, :1].copy()],
         dict(clip, lr=0.1), UPDATE_TOL)]
    return cases


def op_families_check(dev):
    """Part e: each new op family on the card against the port's CPU
    version on one input set -> {op: max abs err}."""
    errs = {}
    for name, ins, params, tol in op_cases():
        op = mt.ops.registry.get(name)
        kw = dict(params, ctx=dev) if not ins else params
        if op.is_random:
            mt.random.seed(0)
        card = op.fn(*[torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                       for x in ins], **kw)
        if op.is_random:
            mt.random.seed(0)
        cpu = op.fn(*[torch.from_numpy(np.ascontiguousarray(x))
                      for x in ins],
                    **dict(params, ctx=None) if "ctx" in kw else params)
        card = card if isinstance(card, tuple) else (card,)
        cpu = cpu if isinstance(cpu, tuple) else (cpu,)
        worst = 0.0
        for a, b in zip(card, cpu):
            if a.device != torch.device(dev):
                raise RuntimeError("%s left the card" % name)
            a, b = a.cpu().float().numpy(), b.float().numpy()
            ok = (np.array_equal(a, b, equal_nan=True) if tol is None
                  else np.allclose(a, b, equal_nan=True, **tol))
            if a.shape != b.shape or not ok:
                raise RuntimeError("%s on the card differs from the CPU: "
                                   "max abs err %g (%s)" % (
                                       name, float(np.nanmax(np.abs(a - b)))
                                       if a.shape == b.shape else -1,
                                       "bitwise" if tol is None else tol))
            if a.size:
                worst = max(worst, float(np.nanmax(np.abs(a - b))))
        errs["%s/%s" % (name, params.get("ret_typ", ""))
             if name == "topk" else name] = worst
    n_bit = sum(1 for c in op_cases() if c[3] is None)
    log("  %d op cases on the card vs the CPU: %d bitwise, %d within rtol "
        "1e-5 and atol 1e-6 (sums and update ops: 1e-4) (worst abs err "
        "%.3g)"
        % (len(errs), n_bit, len(errs) - n_bit, max(errs.values())))
    return errs


def common_ops_path(dev, card, report):
    """Phase 22 (see the module docstring) -> (B1 launches on
    train_cifar10's path by form, its rows, totals and worst error; B5's
    rows at train_mnist's fc1 and fc2 with their launches)."""
    t_phase = time.perf_counter()
    log("phase 22: the common ops and the optimizers (super_resolution.py, "
        "train_mnist.py, train_cifar10.py, the ten new optimizers, the new "
        "op families)")
    en = example_nets()
    op_errs = op_families_check(dev)
    super_resolution_path(en, dev, card, report)
    b5_rows = mnist_path(en, dev, card, report)
    b1_counts, b1_rows, b1_tot, b1_err = cifar_path(en, dev, card, report)
    optimizers_path(en, dev, card, report)
    released(dev)
    wall = time.perf_counter() - t_phase
    report["common_ops"] = {"op_max_abs_err": op_errs, "wall_s": wall}
    log("phase 22 wall: %.1f s" % wall)
    return b1_counts, b1_rows, b1_tot, b1_err, b5_rows


# ------------------- sparse linear classification and the examples (phase 23)
# examples/sparse_linear_classification.py's defaults, and the upstream
# example's Avazu width (1,000,001 features at batch 8192, upstream
# MXNet's example/sparse/linear_classification/train.py) with the JAX
# example's 12 entries a row, 65,536 rows, 2 epochs
SPARSE = dict(rows=2000, features=1000, batch=64, epochs=6, nnz=12,
              wide_features=1000001, wide_batch=8192, wide_rows=65536,
              wide_epochs=2)
# examples/nce_word2vec.py's defaults
NCE = dict(vocab=512, dim=32, num_neg=15, batch_size=256, steps=300, lr=0.2)
# C15's ranges and shapes (tests/test_torch_port_common_ops.py)
ZIPF_WIDE = ((5000, (64, 2048)), (50000, (64, 256)), (1000000, (16, 512)))
DOT_REL = 1e-5             # sparse.dot card vs CPU, relative L2
EX_FIRST = dict(out=1e-4, grad=1e-3)     # first steps, card vs CPU
NN19 = ("BatchNorm_v1", "CTCLoss", "Convolution_v1", "CuDNNBatchNorm",
        "L2Normalization", "LinearRegressionOutput",
        "LogisticRegressionOutput", "MAERegressionOutput", "Pooling_v1",
        "Softmax", "SoftmaxActivation", "UpSampling",
        "_contrib_AdaptiveAvgPooling2D", "_contrib_BilinearResize2D",
        "_contrib_CTCLoss", "_contrib_ctc_loss", "ctc_loss",
        "softmax_cross_entropy", "softmin")


def zipfian_card_check(dev):
    """Part a: ``_sample_unique_zipfian`` at C15's ranges, three seeds
    each, card against CPU bitwise; and ``random.exp_f32`` on every input
    the op can give it at those ranges (2^23 uniform floats times
    log(range_max)), card against CPU bitwise."""
    op = mt.ops.registry.get("_sample_unique_zipfian")
    for rm, shape in ZIPF_WIDE:
        for seed in (0, 1, 2):
            outs = []
            for ctx in (mt.gpu(0), mt.cpu()):
                mt.random.seed(seed)
                outs.append([o.cpu() for o in op.fn(range_max=rm,
                                                    shape=shape, ctx=ctx)])
            if not all(torch.equal(a, b) for a, b in zip(*outs)):
                raise RuntimeError("_sample_unique_zipfian at range_max %d "
                                   "seed %d: card differs from the CPU"
                                   % (rm, seed))
    u = ((torch.arange(2 ** 23, dtype=torch.int32) | 0x3F800000)
         .view(torch.float32) - 1.0)
    for rm, _ in ZIPF_WIDE:
        x = u * torch.log(torch.tensor(float(rm)))
        card = mt.random.exp_f32(x.to(dev)).cpu()
        if not torch.equal(card.view(torch.int32),
                           mt.random.exp_f32(x).view(torch.int32)):
            raise RuntimeError("exp_f32 at range_max %d: card differs from "
                               "the CPU" % rm)
    log("  C15: _sample_unique_zipfian at range_max %s, seeds 0-2, and "
        "exp_f32 on all 2^23 of its inputs at each: card bitwise the CPU"
        % [r for r, _ in ZIPF_WIDE])


def csr_parts(a):
    return (a._indptr, a._indices, a._values)


def libsvm_card_check(path, features, batch):
    """Part b: every batch of two epochs of ``LibSVMIter`` on the card
    bitwise the CPU's -> the number of batches."""
    it = mt.io.LibSVMIter(path, (features,), batch_size=batch)
    n = 0
    for _ in range(2):
        it.reset()
        with mt.cpu():
            cpu = list(it)
        it.reset()
        for c, b in zip(cpu, it):
            x = b.data[0]
            if x._values.device.type != "cuda" or \
                    b.label[0]._data.device.type != "cuda":
                raise RuntimeError("LibSVMIter's batch is not on the card")
            if b.pad != c.pad or not all(
                    torch.equal(u.cpu(), v) for u, v in zip(
                        csr_parts(x) + (b.label[0]._data,),
                        csr_parts(c.data[0]) + (c.label[0]._data,))):
                raise RuntimeError("LibSVMIter's card batch %d differs from "
                                   "the CPU's" % n)
            n += 1
    return n


def csr_to_cpu(x):
    from mxnet_tpu_torch.ndarray import sparse as tsp
    return tsp.CSRNDArray(x._values.cpu(), x._indptr.cpu(),
                          x._indices.cpu(), x.shape, ctx=mt.cpu())


def dot_rows(x, what, dev, seed):
    """Part c: ``sparse.dot(x, w)`` and ``sparse.dot(x, g,
    transpose_a=True)`` for a card CSR batch ``x``: card against CPU
    within DOT_REL relative L2, two card calls bitwise, then the card's
    time beside the bound (the bytes it must move over the HBM rate) and
    ``torch.sparse.mm`` on the same operands (cuSPARSE; a yardstick off
    the path) -> rows."""
    from mxnet_tpu_torch.ndarray import sparse as tsp
    B, D = x.shape
    g = torch.Generator(device=dev).manual_seed(seed)
    w = mt.nd.NDArray(torch.randn(D, 1, generator=g, device=dev))
    gr = mt.nd.NDArray(torch.randn(B, 1, generator=g, device=dev))
    xc = csr_to_cpu(x)
    nnz = int(x._values.numel())
    cols_touched = int(torch.unique(x._indices).numel())
    rows = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # torch's sparse CSR is beta
        A = torch.sparse_csr_tensor(x._indptr, x._indices, x._values,
                                    (B, D))
        At = torch.sparse_coo_tensor(
            torch.stack([x._indices, x._row_ids()]), x._values,
            (D, B)).coalesce().to_sparse_csr()
    for form, rhs, yard, out_bytes, rhs_bytes in (
            ("csr", w, lambda: torch.sparse.mm(A, w._data),
             B * 4, cols_touched * 4),
            ("csr_t", gr, lambda: torch.sparse.mm(At, gr._data),
             D * 4, B * 4)):
        tr = form == "csr_t"

        def fn():
            return tsp.dot(x, rhs, transpose_a=tr)._data
        a, b = fn(), fn()
        torch.cuda.synchronize()
        if not torch.equal(a, b):
            raise RuntimeError("sparse.dot (%s, %s) gave other bits on a "
                               "second call" % (what, form))
        cpu = tsp.dot(xc, mt.nd.NDArray(rhs._data.cpu()),
                      transpose_a=tr)._data
        err = float((a.cpu() - cpu).norm() / cpu.norm().clamp_min(1e-30))
        if err > DOT_REL:
            raise RuntimeError("sparse.dot (%s, %s): card %.3g relative L2 "
                               "from the CPU" % (what, form, err))
        ys = yard()
        yerr = float((ys.to_dense() if ys.is_sparse else ys).sub(a).norm()
                     / a.norm().clamp_min(1e-30))
        nbytes = nnz * (4 + 8) + (B + 1) * 8 + rhs_bytes + out_bytes
        r = {"shape": "%s (%d, %d) nnz %d" % (form, B, D, nnz),
             "rel_l2_vs_cpu": err, "ms": time_ms(fn, dev),
             "sparse_mm_ms": time_ms(yard, dev), "sparse_mm_rel_l2": yerr,
             "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "ops_ms": 2 * nnz / F32_FLOPS * 1e3}
        r["bound_ms"], r["bound_by"] = bound_of(r["bytes_ms"], r["ops_ms"])
        rows["%s/%s" % (what, form)] = r
        log("  sparse.dot %-8s %-34s ms=%.4f torch.sparse.mm_ms=%.4f "
            "bound_ms=%.5f (%s); card vs CPU %.3g rel L2, two card calls "
            "bitwise" % (what, r["shape"], r["ms"], r["sparse_mm_ms"],
                         r["bound_ms"], r["bound_by"], err))
    return rows


def write_wide_libsvm(path, n, dim, nnz, seed=0):
    """The example's law at a width where its per-row
    ``rng.choice(dim, nnz, replace=False)`` would permute all of ``dim``
    each row: ``nnz`` distinct column ids a row (redrawn until no row
    repeats one), ``randn`` values, the label the sign of ``w_true .
    x``; one vectorised draw."""
    rng = np.random.RandomState(seed)
    w_true = rng.randn(dim)
    idx = rng.randint(0, dim, (n, nnz))
    while True:
        idx.sort(axis=1)
        dup = np.zeros_like(idx, dtype=bool)
        dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
        if not dup.any():
            break
        idx[dup] = rng.randint(0, dim, int(dup.sum()))
    val = rng.randn(n, nnz)
    y = ((w_true[idx] * val).sum(1) > 0).astype(int)
    with open(path, "w") as f:
        for r in range(n):
            f.write("%d %s\n" % (y[r], " ".join(
                "%d:%.4f" % p for p in zip(idx[r], val[r]))))
    return path


def sparse_linear_path(en, dev, card, report):
    """Parts b, c, e and f: ``examples/sparse_linear_classification.py``
    through ``mt`` at its defaults and at the Avazu width."""
    P = SPARSE
    root = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(root, exist_ok=True)
    path = en.make_synthetic_libsvm(os.path.join(root, "lc.libsvm"),
                                    n=P["rows"], dim=P["features"],
                                    nnz=P["nnz"])
    nb = libsvm_card_check(path, P["features"], P["batch"])
    log("  LibSVMIter: %d card batches over two epochs bitwise the CPU's "
        "(CSR indptr, indices, values, labels, pad)" % nb)
    t0 = time.perf_counter()
    wide = write_wide_libsvm(os.path.join(root, "avazu_width.libsvm"),
                             P["wide_rows"], P["wide_features"], P["nnz"])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    wide_it = mt.io.LibSVMIter(wide, (P["wide_features"],),
                               batch_size=P["wide_batch"])
    parse_s = time.perf_counter() - t0
    small = next(iter(mt.io.LibSVMIter(path, (P["features"],),
                                       batch_size=P["batch"]))).data[0]
    wide_it.reset()
    big = next(iter(wide_it)).data[0]
    dots = dot_rows(small, "defaults", dev, 23)
    dots.update(dot_rows(big, "avazu", dev, 24))

    # part e: the defaults; the first epoch's weights against the CPU
    first = {}
    reset_all_counts()
    t0 = time.perf_counter()
    accs = en.sparse_linear(
        mt, path, on_epoch=lambda e, w, b: first.setdefault(
            "card", (w.asnumpy().copy(), b.asnumpy().copy())))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held_counts("sparse_linear_classification.py (no kernel on its path)",
                {})
    en.check_improved("accuracy", accs, lower_is_better=False)
    with mt.cpu():
        en.sparse_linear(mt, path, epochs=1, on_epoch=lambda e, w, b:
                         first.setdefault("cpu", (w.asnumpy().copy(),
                                                  b.asnumpy().copy())))
    w_err = max(float(np.abs(a - b).max())
                for a, b in zip(first["card"], first["cpu"]))
    if w_err > 1e-6:
        raise RuntimeError("sparse_linear_classification's first epoch: "
                           "card weights %.3g from the CPU replay" % w_err)
    log("  sparse_linear_classification.py at its defaults (%d features, "
        "batch %d, %d epochs, adagrad lr 0.5, kvstore local): accuracy %s; "
        "%.2f s; first epoch's weights within %.3g of the CPU replay; no "
        "kernel launched  [%s]" % (P["features"], P["batch"], P["epochs"],
                                    ["%.3f" % a for a in accs], wall, w_err,
                                    card))

    # part f: the Avazu width, 2 epochs; then one epoch profiled
    walls = []
    stamp = [time.perf_counter()]

    def epoch_end(e, w, b):
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - stamp[0])
        stamp[0] = time.perf_counter()
    reset_all_counts()
    stamp[0] = time.perf_counter()
    wide_accs = en.sparse_linear(
        mt, wide, num_features=P["wide_features"],
        batch_size=P["wide_batch"], epochs=P["wide_epochs"],
        on_epoch=epoch_end, it=wide_it)
    held_counts("sparse linear classification at the Avazu width", {})
    n_batches = -(-P["wide_rows"] // P["wide_batch"])
    prof = fit_profile(lambda: en.sparse_linear(
        mt, wide, num_features=P["wide_features"],
        batch_size=P["wide_batch"], epochs=1, it=wide_it))
    bps = [n_batches / w for w in walls]
    log("  the Avazu width (%d features, batch %d, %d rows, %d entries a "
        "row, %d epochs): accuracy %s; file written in %.2f s, parsed in "
        "%.2f s; epoch walls %s s, %s batches/s; one epoch profiled: %.1f "
        "ms wall, %.2f ms device, busy share %.3f  [%s]"
        % (P["wide_features"], P["wide_batch"], P["wide_rows"], P["nnz"],
           P["wide_epochs"], ["%.3f" % a for a in wide_accs], write_s,
           parse_s, ["%.3f" % w for w in walls], ["%.2f" % b for b in bps],
           prof["wall_ms"], prof["device_ms"], prof["device_busy_share"],
           card))
    report["sparse_linear"] = {
        "libsvm_batches_bitwise": nb, "dot": dots, "accuracy": accs,
        "wall_s": wall, "first_epoch_max_abs_err": w_err,
        "avazu": {"accuracy": wide_accs, "epoch_wall_s": walls,
                  "batches_per_s": bps, "write_s": write_s,
                  "parse_s": parse_s, "profile": prof}}


def nn19_cases():
    """(name, inputs, params, tolerance) for each of the 19 names: card
    against CPU, forward and the gradients of every float input."""
    rng = np.random.RandomState(23)

    def x(*shape):
        return rng.uniform(-2, 2, shape).astype(np.float32)
    T, N, C, L = 100, 32, 29, 20
    lab = rng.randint(1, C, (N, L)).astype(np.float32)
    lab_len = rng.randint(5, L + 1, N).astype(np.float32)
    data_len = rng.randint(60, T + 1, N).astype(np.float32)
    small_lab = rng.randint(1, 5, (4, 3)).astype(np.float32)
    tight = dict(rtol=1e-5, atol=1e-6)
    ctc = dict(rtol=1e-4, atol=1e-5)
    ones = np.ones(8, np.float32)
    cases = []
    for head in ("LinearRegressionOutput", "MAERegressionOutput",
                 "LogisticRegressionOutput"):
        cases.append((head, [x(64, 8), rng.rand(64, 8).astype(np.float32)],
                      {"grad_scale": 0.5}, tight))
    cases += [
        ("softmin", [x(16, 10)], {"axis": 1}, tight),
        ("SoftmaxActivation", [x(4, 8, 5, 5)], {"mode": "channel"}, tight),
        ("softmax_cross_entropy",
         [x(16, 10), rng.randint(0, 10, 16).astype(np.float32)], {}, tight),
        ("L2Normalization", [x(4, 8, 5, 5)], {"mode": "spatial"}, tight),
        ("UpSampling", [x(2, 4, 6, 6), x(2, 3, 3, 3)],
         {"scale": 2, "num_args": 2}, tight),
        ("_contrib_BilinearResize2D", [x(2, 4, 7, 9)],
         {"height": 15, "width": 4}, tight),
        ("_contrib_AdaptiveAvgPooling2D", [x(2, 4, 7, 9)],
         {"output_size": (3, 4)}, tight),
        ("CTCLoss", [x(T, N, C), lab, data_len, lab_len],
         {"use_data_lengths": True, "use_label_lengths": True}, ctc),
        ("ctc_loss", [x(T, N, C), lab], {"blank_label": "last"}, ctc),
        ("_contrib_CTCLoss", [x(12, 4, 6), small_lab], {}, ctc),
        ("_contrib_ctc_loss", [x(12, 4, 6), small_lab],
         {"blank_label": "last"}, ctc),
        ("BatchNorm_v1", [x(4, 8, 5, 5), ones, 0 * ones, 0 * ones, ones],
         {"fix_gamma": False}, tight),
        ("CuDNNBatchNorm", [x(4, 8, 5, 5), ones, 0 * ones, 0 * ones, ones],
         {"fix_gamma": False}, tight),
        ("Convolution_v1", [x(2, 3, 9, 9), x(8, 3, 3, 3), x(8)],
         {"kernel": (3, 3), "num_filter": 8, "pad": (1, 1)},
         dict(rtol=1e-4, atol=1e-5)),
        ("Pooling_v1", [x(2, 3, 8, 8)],
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"}, tight),
        ("Softmax", [x(16, 10), rng.randint(0, 10, 16).astype(np.float32)],
         {"grad_scale": 0.5, "normalization": "batch"}, tight)]
    return cases


def nn19_card_check(dev):
    """Part d: each of the 19 names on the card against the CPU, forward
    and gradients (of every float input, under a fixed cotangent) ->
    {name: worst abs err}."""
    errs = {}
    cases = nn19_cases()
    if sorted(c[0] for c in cases) != sorted(NN19):
        raise RuntimeError("part d does not cover the 19 names")
    for name, ins, params, tol in cases:
        op = mt.ops.registry.get(name)
        res = []
        for where in (dev, torch.device("cpu")):
            ts = [torch.from_numpy(a.copy()).to(where) for a in ins]
            for t in ts[:1]:
                t.requires_grad_(True)
            out = op.fn(*ts, **params)
            out = out[0] if isinstance(out, tuple) else out
            cot = torch.linspace(0.5, 1.5, out.numel(),
                                 device=where).reshape(out.shape)
            (out * cot).sum().backward()
            res.append((out.detach().cpu(), ts[0].grad.cpu()))
        worst = 0.0
        for a, b in zip(*res):
            if a.shape != b.shape or not torch.allclose(a, b, **tol):
                raise RuntimeError("%s on the card differs from the CPU: "
                                   "max abs err %g (%s)" % (
                                       name, float((a - b).abs().max()),
                                       tol))
            worst = max(worst, float((a - b).abs().max()))
        errs[name] = worst
    log("  the 19 ops/nn.py names on the card vs the CPU, forward and "
        "gradients (CTC at T 100, N 32, C 29, L 20 with lengths): worst "
        "abs err %.3g (%s)" % (max(errs.values()), max(errs, key=errs.get)))
    return errs


def nce_first_step(en, dev):
    """One step of the NCE loop on the card and on the CPU after the same
    seed -> (the outputs' max abs error, the gradient's)."""
    rec = {}
    for where, ctx in (("card", mt.gpu(0)), ("cpu", mt.cpu())):
        mt.random.seed(0)
        with ctx:
            en.nce_train(mt, ctx, steps=1, check=False,
                         on_step=lambda i, ex: rec.setdefault(where, (
                             en.host(ex.outputs[0]),
                             en.host(ex.grad_dict["embed_weight"]))),
                         **{k: v for k, v in NCE.items() if k != "steps"})
    out_err = float(np.abs(rec["card"][0] - rec["cpu"][0]).max())
    grad_err = float(np.abs(rec["card"][1] - rec["cpu"][1]).max())
    if out_err > 1e-6 or grad_err > 1e-5:
        raise RuntimeError("nce_word2vec's first step: outputs %.3g, "
                           "gradient %.3g from the CPU" % (out_err,
                                                           grad_err))
    return out_err, grad_err


def nce_path(en, dev, card, report):
    """Part g: ``examples/nce_word2vec.py`` at its defaults -> (B2's
    launches, its rows)."""
    from mxnet_tpu_torch.kernels import take
    P = NCE
    reason = take.eligible((P["vocab"], P["dim"]), torch.float32,
                           (P["batch_size"], 1 + P["num_neg"]),
                           torch.float32)
    if reason is not None:
        raise RuntimeError("B2's guard declines the NCE lookups: %s" % reason)
    g = torch.Generator(device=dev).manual_seed(23)
    rows = {}
    b2_row(rows, "take_rows@nce_ctx", P["vocab"], P["dim"],
           (P["batch_size"],), dev, g)
    b2_row(rows, "take_rows@nce_cands", P["vocab"], P["dim"],
           (P["batch_size"], 1 + P["num_neg"]), dev, g)
    out_err, grad_err = nce_first_step(en, dev)
    reset_all_counts()
    mt.random.seed(0)
    t0 = time.perf_counter()
    losses, _, hits = en.nce_train(mt, mt.gpu(0), **P)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    want = 2 * P["steps"]
    counts = held_counts("nce_word2vec.py", {"take_rows": want})
    log("  nce_word2vec.py at its defaults (vocab %d, dim %d, %d negatives, "
        "batch %d, %d steps): NLL %.4f -> %.4f, partner-nearest-neighbour "
        "rate %.2f; %.2f s (%.2f ms a step); B2 launched %d times (2 "
        "Embedding lookups a step, the guard's count at the (%d, %d) "
        "table); first step vs the CPU: outputs %.3g, gradient %.3g  [%s]"
        % (P["vocab"], P["dim"], P["num_neg"], P["batch_size"], P["steps"],
           losses[0], losses[-1], hits, wall, wall / P["steps"] * 1e3,
           counts["take_rows"], P["vocab"], P["dim"], out_err, grad_err,
           card))
    report["nce_word2vec"] = {"nll_first": float(losses[0]),
                              "nll_last": float(losses[-1]),
                              "partner_rate": hits, "wall_s": wall,
                              "take_rows_launches": counts["take_rows"],
                              "first_step": [out_err, grad_err],
                              "b2_rows": rows}
    return counts["take_rows"], rows


def param_grads(net):
    return {k: p.grad().asnumpy().copy()
            for k, p in net.collect_params().items()
            if p.grad_req != "null"}


def first_step_check(what, make, step, seed):
    """Build the net on the CPU (``make(ctx)`` initializes it and runs a
    forward), carry its weights to a card net, run ``step(net, ctx)``
    (one forward and backward under ``record`` -> the loss) on both
    after the same key-chain seed -> (loss max abs err, worst gradient
    relative L2)."""
    res = {}
    ref = None
    for where, ctx in (("cpu", mt.cpu()), ("card", mt.gpu(0))):
        with ctx:
            mt.random.seed(seed)
            np.random.seed(seed)
            nets = make(ctx, ref)
            if ref is None:
                ref = [{n[len(b.prefix):]: p.data().asnumpy()
                        for n, p in b.collect_params().items()}
                       for b in nets]
            mt.random.seed(seed + 1)
            loss = step(nets, ctx).asnumpy()
            grads = {}
            for b in nets:
                grads.update({n[len(b.prefix):]: torch.from_numpy(v)
                              for n, v in param_grads(b).items()})
            res[where] = (loss, grads)
    loss_err = float(np.abs(res["card"][0] - res["cpu"][0]).max())
    grad_err = max(rel_l2(res["card"][1], res["cpu"][1]).values())
    if loss_err > EX_FIRST["out"] * max(1.0, float(np.abs(
            res["cpu"][0]).max())) or grad_err > EX_FIRST["grad"]:
        raise RuntimeError("%s's first step: loss %.3g, gradients %.3g "
                           "relative L2 from the CPU" % (what, loss_err,
                                                         grad_err))
    return loss_err, grad_err


def cnn_path(en, dev, card, report):
    """Part h: ``examples/gluon_cnn.py`` at its defaults."""
    X, y = en.cnn_data()

    def make(ctx, ref):
        net = en.cnn_net(mt.gluon)
        if ref is None:
            net.initialize(mt.init.Xavier(), ctx=ctx)
            net(mt.nd.array(X[:2], ctx=ctx))
        else:
            mt.gluon.utils.params_from_reference(net, ref[0], ctx=ctx)
        net.hybridize()
        return [net]

    def step(nets, ctx):
        with mt.autograd.record():
            loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
                nets[0](mt.nd.array(X[:32], ctx=ctx)),
                mt.nd.array(y[:32], ctx=ctx))
        loss.backward()
        return loss
    first = first_step_check("gluon_cnn.py", make, step, 1)
    mt.random.seed(0)
    np.random.seed(0)
    net = en.cnn_net(mt.gluon)
    net.initialize(mt.init.Xavier())
    net.hybridize()
    reset_all_counts()
    t0 = time.perf_counter()
    hist = en.cnn_train(mt, net, X, y)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held_counts("gluon_cnn.py (no kernel on its path)", {})
    losses = [h[0] for h in hist]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise RuntimeError("gluon_cnn's loss did not fall: %s" % hist)
    log("  gluon_cnn.py at its defaults (batch 32, 3 epochs, hybridized): "
        "(loss, accuracy) by epoch %s; %.2f s; first step vs the CPU: loss "
        "%.3g, gradients %.3g relative L2; no kernel launched  [%s]"
        % (["(%.4f, %.3f)" % h for h in hist], wall, first[0], first[1],
           card))
    report["gluon_cnn"] = {"epochs": hist, "wall_s": wall,
                           "first_step": first}


def dcgan_path(en, dev, card, report):
    """Part h: ``examples/train_dcgan.py`` at its defaults."""
    rng = np.random.RandomState(0)
    imgs = en.dcgan_images(256, rng)
    z0 = np.random.RandomState(1).randn(32, 64, 1, 1).astype(np.float32)

    def make(ctx, ref):
        gen, disc = en.dcgan_nets(mt.gluon)
        if ref is None:
            gen.initialize(mt.init.Normal(0.02), ctx=ctx)
            disc.initialize(mt.init.Normal(0.02), ctx=ctx)
            disc(gen(mt.nd.array(z0[:2], ctx=ctx)))
        else:
            mt.gluon.utils.params_from_reference(gen, ref[0], ctx=ctx)
            mt.gluon.utils.params_from_reference(disc, ref[1], ctx=ctx)
        gen.hybridize()
        disc.hybridize()
        return [gen, disc]

    def step(nets, ctx):
        gen, disc = nets
        bce = mt.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        with mt.autograd.record():
            out_real = disc(mt.nd.array(imgs[:32], ctx=ctx)).reshape((-1,))
            out_fake = disc(gen(mt.nd.array(z0, ctx=ctx))).reshape((-1,))
            loss = bce(out_real, mt.nd.ones((32,), ctx=ctx)) + \
                bce(out_fake, mt.nd.zeros((32,), ctx=ctx))
        loss.backward()
        return loss
    first = first_step_check("train_dcgan.py", make, step, 2)
    ctx = mt.gpu(0)
    mt.random.seed(0)
    np.random.seed(0)
    gen, disc = en.dcgan_nets(mt.gluon)
    gen.initialize(mt.init.Normal(0.02), ctx=ctx)
    disc.initialize(mt.init.Normal(0.02), ctx=ctx)
    gen.hybridize()
    disc.hybridize()
    reset_all_counts()
    t0 = time.perf_counter()
    hist = en.dcgan_train(mt, ctx, gen, disc, rng, imgs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held_counts("train_dcgan.py (BatchNorm -> relu under Gluon fuses into "
                "no B1, as in the JAX package)", {})
    log("  train_dcgan.py at its defaults (batch 32, 3 epochs, nz 64, 256 "
        "images, ngf = ndf = 32): (d_loss, g_loss, fool rate) by epoch %s, "
        "the example's collapse check passed; %.2f s; first step vs the "
        "CPU: loss %.3g, gradients %.3g relative L2; no kernel launched  "
        "[%s]" % (["(%.3f, %.3f, %.2f)" % h for h in hist], wall, first[0],
                  first[1], card))
    report["train_dcgan"] = {"epochs": hist, "wall_s": wall,
                             "first_step": first}


def vae_path(en, dev, card, report):
    """Part h: ``examples/train_vae.py`` at its defaults."""
    X = en.vae_images(512, np.random.RandomState(0))

    def make(ctx, ref):
        net = en.vae_net(mt.gluon, n_out=X.shape[1])
        if ref is None:
            net.initialize(mt.init.Xavier(), ctx=ctx)
            net(mt.nd.array(X[:2], ctx=ctx))
        else:
            mt.gluon.utils.params_from_reference(net, ref[0], ctx=ctx)
        net.hybridize()
        return [net]

    def step(nets, ctx):
        x = mt.nd.array(X[:64], ctx=ctx)
        bce = mt.gluon.loss.SigmoidBinaryCrossEntropyLoss(from_sigmoid=True)
        with mt.autograd.record():
            y, kl = nets[0](x)
            loss = bce(y, x) * X.shape[1] + kl
        loss.backward()
        return loss
    first = first_step_check("train_vae.py", make, step, 3)
    ctx = mt.gpu(0)
    mt.random.seed(0)
    np.random.seed(0)
    net = en.vae_net(mt.gluon, n_out=X.shape[1])
    net.initialize(mt.init.Xavier(), ctx=ctx)
    net.hybridize()
    reset_all_counts()
    t0 = time.perf_counter()
    elbos = en.vae_train(mt, ctx, net, X)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    held_counts("train_vae.py (no kernel on its path)", {})
    log("  train_vae.py at its defaults (batch 64, 5 epochs, 512 images, "
        "8 latents): -ELBO by epoch %s, the example's check passed; %.2f s; "
        "first step vs the CPU (eps from the key chain on each): loss %.3g, "
        "gradients %.3g relative L2; no kernel launched  [%s]"
        % (["%.3f" % e for e in elbos], wall, first[0], first[1], card))
    report["train_vae"] = {"elbo": elbos, "wall_s": wall,
                           "first_step": first}


def examples_path(dev, card, report):
    """Phase 23 (see the module docstring) -> (B2's launches on the NCE
    path, its rows)."""
    t_phase = time.perf_counter()
    log("phase 23: sparse linear classification (BASELINE configuration 5), "
        "the rest of ops/nn.py, nce_word2vec.py, gluon_cnn.py, "
        "train_dcgan.py and train_vae.py")
    en = example_nets()
    zipfian_card_check(dev)
    sparse_linear_path(en, dev, card, report)
    nn_errs = nn19_card_check(dev)
    nce_launches, nce_rows = nce_path(en, dev, card, report)
    cnn_path(en, dev, card, report)
    dcgan_path(en, dev, card, report)
    vae_path(en, dev, card, report)
    released(dev)
    wall = time.perf_counter() - t_phase
    report["examples"] = {"nn_ops_max_abs_err": nn_errs, "wall_s": wall}
    log("phase 23 wall: %.1f s" % wall)
    return nce_launches, nce_rows



# ------------------------------------ multi-process training (phase 24)
# Each part's ranks are started by the port's launcher and share cuda:0
# (gloo: NCCL refuses two ranks on one device); every rank runs
# ``python3 chip_smoke.py --worker <part> --out <dir>`` and writes its
# results to <dir>/<part>_rank<r>.json for the parent to hold.
DIST = dict(ranks=2, resnet_batch=64, resnet_steps=8, chw=(3, 224, 224),
            mnist_batch=64, mnist_epochs=2, kill_step=7, timeout=600)
DIST_DIR = os.path.join(REPO, "build", "chip_smoke", "dist")


def dist_launch(part, n, *launcher_args, env=None):
    """One launch of ``n`` ranks of ``--worker part`` -> (wall s, stdout).
    A failed rank fails the launch and the phase (the launcher returns
    the first failing rank's code; nothing here catches it)."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.tools.launch", "-n",
           str(n)] + list(launcher_args) \
        + [sys.executable, os.path.abspath(__file__), "--worker", part,
           "--out", DIST_DIR]
    full = dict(os.environ)
    # every rank of every launch imports torch: where the environment
    # writes no bytecode (PYTHONDONTWRITEBYTECODE), each one compiles
    # torch's sources again, ~10 s a process; the ranks share a cache
    # under build/ instead
    full.pop("PYTHONDONTWRITEBYTECODE", None)
    full["PYTHONPYCACHEPREFIX"] = os.path.join(REPO, "build", "chip_smoke",
                                               "pycache")
    full.update(env or {})
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=full, capture_output=True,
                       text=True, timeout=DIST["timeout"])
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError("phase 24 part %s (%d ranks) failed, rc %d:\n%s\n%s"
                           % (part, n, r.returncode, r.stdout[-6000:],
                              r.stderr[-4000:]))
    return wall, r.stdout + r.stderr


def dist_results(part, n):
    out = []
    for rank in range(n):
        with open(os.path.join(DIST_DIR, "%s_rank%d.json" % (part, rank))) \
                as f:
            out.append(json.load(f))
    return out


def worker_dump(part, obj):
    from mxnet_tpu_torch.parallel import dist
    with open(os.path.join(DIST_DIR, "%s_rank%d.json" % (part, dist.rank())),
              "w") as f:
        json.dump(obj, f, default=float)


def digest(t):
    """sha256 of a tensor's bytes (on the host)."""
    import hashlib
    return hashlib.sha256(t.detach().contiguous().cpu().view(-1)
                          .view(torch.uint8).numpy().tobytes()).hexdigest()


def dist_stats_delta(before):
    from mxnet_tpu_torch.parallel import dist
    now = dist.stats()
    return {k: {f: v[f] - before.get(k, {}).get(f, 0) for f in v}
            for k, v in now.items()}


# ---- part a: the nightly dist_sync invariants, every value on the card
def worker_invariants():
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_dist_worker as w
    with mt.gpu(0):
        w.invariants()


# ---- part b: sparse linear classification at the Avazu width
def worker_sparse():
    from mxnet_tpu_torch.parallel import dist
    worker_invariants()      # part a at 2 ranks
    en = example_nets()
    P = SPARSE
    rank, n = dist.rank(), dist.num_workers()
    wide = os.path.join(REPO, "build", "chip_smoke", "avazu_width.libsvm")
    it = mt.io.LibSVMIter(wide, (P["wide_features"],),
                          batch_size=P["wide_batch"], num_parts=n,
                          part_index=rank)
    stores, pushes = [], []
    create, push = mt.kv.create, mt.kv.KVStore.push

    def made(name="local"):
        stores.append(create(name))
        return stores[-1]

    def recorded(self, key, value, priority=0):
        if self._type == "dist_sync":
            if isinstance(value, mt.nd.sparse.RowSparseNDArray):
                pushes.append({"key": key,
                               "values": value._values.cpu().numpy(),
                               "indices": value._indices.cpu().numpy()})
            else:
                pushes.append({"key": key, "dense": value._data.cpu()
                               .numpy() if hasattr(value, "_data")
                               else value.cpu().numpy()})
        return push(self, key, value, priority)
    mt.kv.create, mt.kv.KVStore.push = made, recorded
    res = {}
    try:
        for name in ("dist_sync", "dist_async"):
            walls, last = [], {}
            stamp = [0.0]

            def epoch_end(e, w_, b_):
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - stamp[0])
                last["w"], last["b"] = w_._data.clone(), b_._data.clone()
                stamp[0] = time.perf_counter()
            dist.barrier("sparse_" + name)
            before = dist.stats()
            stamp[0] = time.perf_counter()
            accs = en.sparse_linear(
                mt, wide, num_features=P["wide_features"],
                batch_size=P["wide_batch"], epochs=P["wide_epochs"],
                kv_store=name, on_epoch=epoch_end, it=it)
            coll = dist_stats_delta(before)
            kv = stores[-1]
            r = {"accuracy": accs, "epoch_wall_s": walls,
                 "collectives": coll,
                 "w_finite": bool(torch.isfinite(last["w"]).all()),
                 "w_digest": digest(last["w"]), "b_digest": digest(last["b"])}
            if name == "dist_sync":
                np.savez(os.path.join(DIST_DIR, "sparse_pushes_rank%d.npz"
                                      % rank),
                         **{"%d_%s" % (i, k): v for i, p in enumerate(pushes)
                            for k, v in p.items() if k != "key"},
                         keys=np.array([p["key"] for p in pushes]))
                r["pushes"] = len(pushes)
                # one more epoch, profiled on every rank
                dist.barrier("sparse_prof")
                r["profile"] = fit_profile(lambda: en.sparse_linear(
                    mt, wide, num_features=P["wide_features"],
                    batch_size=P["wide_batch"], epochs=1,
                    kv_store="dist_sync", it=it))
            else:
                kv._barrier()   # every rank's pushes are in
                if rank == 0:
                    r["server_pushes"] = len(
                        kv._async_client.call("stats")["pushes"])
                    r["server_device"] = str(kv._async_server.device)
            res[name] = r
    finally:
        mt.kv.create, mt.kv.KVStore.push = create, push
    worker_dump("b", res)


def sparse_replay(dev, n):
    """Part b's check: a one-process replay on the card pushing each
    step's gradients of every rank as a list to a ``local`` store with
    the same AdaGrad -> (weight, bias) digests."""
    P = SPARSE
    F = P["wide_features"]
    rec = [np.load(os.path.join(DIST_DIR, "sparse_pushes_rank%d.npz" % r))
           for r in range(n)]
    keys = rec[0]["keys"]
    if any(not np.array_equal(z["keys"], keys) for z in rec):
        raise RuntimeError("the ranks pushed different keys")
    kv = mt.kv.create("local")
    kv.set_optimizer(mt.optimizer.create("adagrad", learning_rate=0.5))
    weight = mt.nd.zeros((F, 1), ctx=mt.gpu(0))
    bias = mt.nd.zeros((1,), ctx=mt.gpu(0))
    kv.init(0, weight)
    kv.init(1, bias)
    for i, key in enumerate(keys):
        vals = []
        for z in rec:
            if "%d_values" % i in z.files:
                vals.append(mt.nd.sparse.RowSparseNDArray(
                    torch.from_numpy(z["%d_values" % i]).to(dev),
                    torch.from_numpy(z["%d_indices" % i]).to(dev), (F, 1),
                    ctx=mt.gpu(0)))
            else:
                vals.append(mt.nd.array(z["%d_dense" % i], ctx=mt.gpu(0)))
        kv.push(int(key), vals)
    kv.pull(0, out=weight, ignore_sparse=False)
    kv.pull(1, out=bias)
    return digest(weight._data), digest(bias._data), len(keys)


# ---- part c: ResNet-50 at dist_sync, the kvstore path and DDP
def worker_resnet():
    from mxnet_tpu_torch.parallel import dist
    P = DIST
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    rank, n = dist.rank(), dist.num_workers()
    B = P["resnet_batch"]
    sym = resnet50()
    p0, aux0 = resnet_init(sym, dev, P["chw"], rnd_type="gaussian")
    X, Y = image_batch(B * n, seed=0, chw=P["chw"])
    X, Y = X[rank * B:(rank + 1) * B], Y[rank * B:(rank + 1) * B]
    res = {}
    for run, ddp, mb, cdt in (("kvstore", False, 0.0, "auto"),
                              ("ddp_1mb", True, 1.0, "auto"),
                              ("ddp_auto", True, 0.0, "auto"),
                              ("ddp_64mb", True, 64.0, "auto"),
                              ("ddp_64mb_f32", True, 64.0, "float32")):
        it = OneBatchIter(X, Y, P["resnet_steps"], dev)
        lab = it.batch.label[0].long()
        mod = mt.mod.Module(sym, context=dev)
        losses, stamps, first = [], [], {}

        def record(_p):
            out = mod.get_outputs()[0].float()
            losses.append(float(-out.gather(1, lab.unsqueeze(1))
                                .clamp_min(1e-30).log().mean()))
            stamps.append(time.perf_counter())
        torch.cuda.reset_peak_memory_stats(dev)
        reset_all_counts()
        tier.reset_stats()
        dist.barrier("resnet_" + run)
        before = dist.stats()
        mt.random.seed(0)
        with mt.config.override(ddp=ddp, ddp_bucket_mb=mb,
                                compute_dtype=cdt):
            mod.bind(it.provide_data, it.provide_label)
            mod.init_params(arg_params=p0, aux_params=aux0)
            mod.init_optimizer(kvstore=mt.kv.create("dist_sync"),
                               optimizer="sgd",
                               optimizer_params=dict(IMAGENET_SGD))
            if ddp:
                red = mod._fused.reducer
                reduce = red.reduce

                def first_reduce(grads):
                    out = reduce(grads)
                    if not first:
                        first.update({k: digest(v) for k, v in out.items()})
                    return out
                red.reduce = first_reduce
            stamps.append(time.perf_counter())
            mod.fit(it, num_epoch=1, eval_metric=None, batch_end_callback=
                    record, steps_per_dispatch=1)
            torch.cuda.synchronize()
        coll = dist_stats_delta(before)
        counts = held_counts("phase 24 ResNet-50 %s rank %d" % (run, rank),
                             {"bn_act": 33 * P["resnet_steps"],
                              "bn_act_res": 16 * P["resnet_steps"]})
        args, aux = mod.get_params()
        r = {"losses": losses, "step_ms": list(np.diff(stamps) * 1e3),
             "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
             "collectives": coll, "launches": counts,
             "ddp": mod._ddp, "update_on_kvstore": mod._update_on_kvstore,
             "compute": "eager f32" if mod._fused is None else "fused %s"
             % str(mod._fused.compute_dtype or torch.float32)[6:],
             "params": {k: digest(v) for k, v in sorted(args.items())},
             "aux": {k: digest(v) for k, v in sorted(aux.items())}}
        if ddp:
            st = mod.ddp_stats()
            r.update(ddp_stats={k: v for k, v in st.items()
                                if k != "reduce_ms"},
                     reduce_ms=st["reduce_ms"], first_grads=first)
        if run == "ddp_64mb":
            # two more steps, profiled on every rank
            dist.barrier("resnet_prof")
            it2 = OneBatchIter(X, Y, 2, dev)
            r["profile"] = fit_profile(lambda: mod.fit(
                it2, num_epoch=1, eval_metric=None, steps_per_dispatch=1,
                force_init=False))
        res[run] = r
        del mod
        torch.cuda.empty_cache()
    worker_dump("c", res)


def resnet_replay(dev, n):
    """Part c's check: the first step's summed gradient, replayed in one
    process on the card: the two half-batches' forward and backward in
    turn (the fused bf16 step at the same weights), added in rank order
    -> {name: digest}."""
    P = DIST
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    B = P["resnet_batch"]
    sym = resnet50()
    p0, aux0 = resnet_init(sym, dev, P["chw"], rnd_type="gaussian")
    X, Y = image_batch(B * n, seed=0, chw=P["chw"])
    mod = mt.mod.Module(sym, context=dev)
    mod.bind([("data", (B,) + tuple(P["chw"]))], [("softmax_label", (B,))])
    mod.init_params(arg_params=p0, aux_params=aux0)
    mod.init_optimizer(kvstore="tpu_sync", optimizer="sgd",
                       optimizer_params=dict(IMAGENET_SGD))
    total = None
    for r in range(n):
        batch = mt.io.DataBatch(
            data=[torch.from_numpy(X[r * B:(r + 1) * B]).to(dev)],
            label=[torch.from_numpy(Y[r * B:(r + 1) * B]).to(dev)])
        mt.random.seed(0)
        mod.forward_backward(batch)
        g = {k: v.clone() for k, v in mod._fused_grads.items()}
        total = g if total is None else {k: total[k] + g[k] for k in g}
        mod._fused_grads = None
    out = {k: digest(v) for k, v in total.items()}
    del mod, total
    torch.cuda.empty_cache()
    return out


# ---- part d: train_mnist.py's MLP at dist_sync, killed and resumed
def worker_mnist():
    from mxnet_tpu_torch.parallel import dist
    logging.basicConfig(level=logging.INFO)   # the resume's log line
    P = DIST
    en = example_nets()
    rank, n = dist.rank(), dist.num_workers()
    Xt, yt, _, _ = en.mnist_data()
    half = len(Xt) // n
    Xt, yt = Xt[rank * half:(rank + 1) * half], yt[rank * half:(rank + 1)
                                                   * half]
    sym = en.mlp_symbol(mt.sym)
    mt.random.seed(0)
    it = mt.io.NDArrayIter(Xt, yt, P["mnist_batch"])
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    reset_all_counts()
    tier.reset_stats()
    t0 = time.perf_counter()
    mod.fit(it, num_epoch=P["mnist_epochs"], kvstore="dist_sync",
            optimizer="sgd", optimizer_params=dict(EX["mnist"]["sgd"]),
            initializer=mt.init.Xavier(), eval_metric=None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    args, _ = mod.get_params()
    tag = os.environ.get("PHASE24_RUN", "run")
    np.savez(os.path.join(DIST_DIR, "mnist_%s_rank%d.npz" % (tag, rank)),
             **{k: v.cpu().numpy() for k, v in args.items()})
    worker_dump("d_" + tag, {"wall_s": wall, "launches": all_counts(),
                             "fallback": tier.stats()["fallback"],
                             "steps": P["mnist_epochs"] * it.num_batches
                             if hasattr(it, "num_batches") else None})


def worker_main(part, out):
    """One rank of a phase-24 part (under the port's launcher)."""
    global DIST_DIR
    DIST_DIR = out
    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxnet_tpu_torch.parallel import dist
    {"a": worker_invariants, "b": worker_sparse, "c": worker_resnet,
     "d": worker_mnist}[part]()
    dist.shutdown()
    return 0


def dist_part_a(dev, card, walls):
    """Part a at 3 ranks, with dead-node detection (part b's launch runs
    them at 2 ranks first, one launch fewer)."""
    for k in (3,):
        walls["a%d" % k], out = dist_launch(
            "a", k, "--max-restarts", "0", "--env",
            "MXNET_HEARTBEAT_INTERVAL=0.2")
        want = ["rank %d/%d: all dist_sync invariants OK" % (r, k)
                for r in range(k)]
        if k == 3:
            want += ["rank %d/3: fault detection OK" % r for r in range(3)]
        missing = [w for w in want if w not in out]
        if missing:
            raise RuntimeError("part a: %s missing:\n%s" % (missing,
                                                            out[-3000:]))
        log("  (a) the nightly dist_sync invariants at %d ranks on cuda:0 "
            "(init broadcast, the 'test' optimizer, replace, row_sparse, "
            "2-bit over the wire, collectives, dist_async through rank 0's "
            "server%s): %.1f s wall" % (k, ", get_num_dead_node with the "
                                        "last rank silent" if k == 3 else "",
                                        walls["a%d" % k]))



def dist_part_b(dev, card, walls, P=DIST):
    """Part b: sparse linear classification at the Avazu width -> the
    ranks' results."""
    n = P["ranks"]
    Sp = SPARSE
    wide = os.path.join(REPO, "build", "chip_smoke", "avazu_width.libsvm")
    if not os.path.exists(wide):
        write_wide_libsvm(wide, Sp["wide_rows"], Sp["wide_features"],
                          Sp["nnz"])
    walls["b"], out = dist_launch("b", n, "--max-restarts", "0")
    missing = [r for r in range(n) if "rank %d/%d: all dist_sync invariants "
               "OK" % (r, n) not in out]
    if missing:
        raise RuntimeError("part a at %d ranks: ranks %s missing:\n%s"
                           % (n, missing, out[-3000:]))
    log("  (a) the nightly dist_sync invariants at %d ranks on cuda:0 (run "
        "first in part b's launch)" % n)
    rb = dist_results("b", n)
    w_d, b_d, n_push = sparse_replay(dev, n)
    sync = [r["dist_sync"] for r in rb]
    if any((s["w_digest"], s["b_digest"]) != (w_d, b_d) for s in sync):
        raise RuntimeError("part b: dist_sync's final weights are not "
                           "bitwise the one-process replay")
    asy = [r["dist_async"] for r in rb]
    # the same batches and epochs at dist_async: the same pushes a rank
    expected = sum(s["pushes"] for s in sync)
    if asy[0]["server_pushes"] != expected or not all(
            a["w_finite"] and a["accuracy"][-1] > a["accuracy"][0]
            for a in asy):
        raise RuntimeError("part b: dist_async %s (server pushes %s, want "
                           "%d)" % (asy, asy[0].get("server_pushes"),
                                    expected))
    batches = sync[0]["pushes"] // 2
    ar = sync[0]["collectives"].get("allreduce", {})
    for name, rs in (("dist_sync", sync), ("dist_async", asy)):
        ep = [max(w) for w in zip(*[r["epoch_wall_s"] for r in rs])]
        bps = [n * (batches // len(ep)) / w for w in ep]
        log("  (b) sparse_linear_classification.py at the Avazu width, %s, "
            "%d ranks on their halves: accuracy %s; epoch walls %s s, %s "
            "batches/s over both ranks (phase 23's one process: 24.9-32.1 "
            "(PERF.md))%s  [%s]"
            % (name, n, ["%.3f" % a for a in rs[0]["accuracy"]],
               ["%.3f" % w for w in ep], ["%.2f" % b for b in bps],
               "; all-reduce %.3f ms and %.0f bytes a batch (its two "
               "pushes; %d collectives in %d batches), busy share %.3f of "
               "%.1f ms (rank 0, one epoch profiled)"
               % (ar["ms"] / batches, ar["bytes"] / batches, ar["calls"],
                  batches,
                                    rs[0]["profile"]["device_busy_share"],
                                    rs[0]["profile"]["wall_ms"])
               if name == "dist_sync" else "; server pushes %d, each "
               "applied once" % asy[0]["server_pushes"], card))
    log("  (b) dist_sync's final weight and bias bitwise the one-process "
        "replay of %d pushes (both ranks' gradients a step as a list to a "
        "local store, AdaGrad lr 0.5): %.1f s wall" % (n_push, walls["b"]))

    return rb


def dist_part_c(dev, card, report, sites, walls, P=DIST):
    """Part c: ResNet-50, the kvstore path and DDP at 1 MiB, the
    automatic bucket size (``MXNET_DDP_BUCKET_MB`` unset) and 64 MiB ->
    (the ranks' results, the paths' rows, B1's checks at batch 64 in
    bf16 and f32)."""
    n = P["ranks"]
    torch.backends.cudnn.deterministic = True
    b1_bf16 = b1_train_phase(sites, dev, batch=P["resnet_batch"])
    b1_f32 = b1_train_phase(sites, dev, batch=P["resnet_batch"],
                            dtype=torch.float32)
    walls["c"], _ = dist_launch("c", n, "--max-restarts", "0")
    rc = dist_results("c", n)
    replay = resnet_replay(dev, n)
    torch.backends.cudnn.deterministic = False
    for run in rc[0]:
        if any(r[run]["params"] != rc[0][run]["params"] for r in rc):
            raise RuntimeError("part c %s: the ranks' weights differ" % run)
        if not all(falling(r[run]["losses"]) for r in rc):
            raise RuntimeError("part c %s: losses do not fall: %s"
                               % (run, [r[run]["losses"] for r in rc]))
    c0 = rc[0]
    for run in ("ddp_auto", "ddp_64mb"):
        if c0["ddp_1mb"]["params"] != c0[run]["params"] or \
                c0["ddp_1mb"]["aux"] != c0[run]["aux"]:
            raise RuntimeError("part c: the bucket size changed the weights "
                               "(%s against ddp_1mb)" % run)
    if c0["ddp_64mb_f32"]["params"] != c0["kvstore"]["params"]:
        diff = [k for k in c0["kvstore"]["params"]
                if c0["kvstore"]["params"][k] !=
                c0["ddp_64mb_f32"]["params"][k]]
        raise RuntimeError("part c: DDP in f32 is not bitwise the kvstore "
                           "path (%d of %d parameters differ: %s)"
                           % (len(diff), len(c0["kvstore"]["params"]),
                              diff[:5]))
    for r in rc:
        if r["ddp_1mb"]["first_grads"] != replay:
            raise RuntimeError("part c: the first step's all-reduced "
                               "gradient is not bitwise the one-process "
                               "replay")
    if not (c0["kvstore"]["update_on_kvstore"] and all(
            c0[k]["ddp"] for k in ("ddp_1mb", "ddp_auto", "ddp_64mb",
                                   "ddp_64mb_f32"))):
        raise RuntimeError("part c: the paths did not engage as asked")
    img_n = n * P["resnet_batch"]
    rows_c = {}
    for run in ("kvstore", "ddp_1mb", "ddp_auto", "ddp_64mb",
                "ddp_64mb_f32"):
        st = [max(s) for s in zip(*[r[run]["step_ms"][1:] for r in rc])]
        p50 = float(np.median(st))
        ar = c0[run]["collectives"].get("allreduce", {"calls": 0,
                                                      "bytes": 0, "ms": 0})
        steps = P["resnet_steps"]
        rows_c[run] = {"step_ms_p50": p50, "img_per_s": img_n * 1e3 / p50,
                       "allreduce_ms_step": ar["ms"] / steps,
                       "allreduce_bytes_step": ar["bytes"] / steps,
                       "collectives_step": ar["calls"] / steps,
                       "peak_gb": [r[run]["peak_gb"] for r in rc]}
        log("  (c) ResNet-50 %s (%s): step p50 %.2f ms (steps 2-%d, "
            "the slower rank), %.1f images/s over both ranks; all-reduce "
            "%.2f ms and %.1f MB a step in %.0f collectives; peak memory %s "
            "GB; losses %s -> %s  [%s]"
            % (run, c0[run]["compute"], p50, steps,
               rows_c[run]["img_per_s"], rows_c[run]["allreduce_ms_step"],
               rows_c[run]["allreduce_bytes_step"] / 1e6,
               rows_c[run]["collectives_step"],
               ["%.2f" % g for g in rows_c[run]["peak_gb"]],
               "%.3f" % c0[run]["losses"][0], "%.3f" % c0[run]["losses"][-1],
               card))
    prof = [r["ddp_64mb"]["profile"] for r in rc]
    one = report.get("resnet_train", {}).get("bf16", {}).get("step_ms_p50")
    log("  (c) DDP buckets: %d at 1 MiB, %d at the automatic %d bytes, %d "
        "at 64 MiB; busy share %s "
        "(each rank, 2 profiled DDP steps); phase 13's one-process bf16 "
        "step at batch 128 in this run: %s ms. Weights bitwise across "
        "ranks in every run, the three bucket sizes bitwise, DDP in f32 "
        "bitwise the kvstore path (f32 eager: the kvstore path's update "
        "runs in the store, outside the fused bf16 step), the first "
        "step's all-reduced gradient bitwise the one-process replay of "
        "the two half-batches; B1 %s a rank and run, no fallback: %.1f s "
        "wall" % (c0["ddp_1mb"]["ddp_stats"]["buckets"],
                  c0["ddp_auto"]["ddp_stats"]["buckets"],
                  c0["ddp_auto"]["ddp_stats"]["bucket_bytes_plan"],
                  c0["ddp_64mb"]["ddp_stats"]["buckets"],
                  ["%.3f" % p["device_busy_share"] for p in prof],
                  "%.2f" % one if one else "not measured",
                  json.dumps(c0["kvstore"]["launches"]), walls["c"]))

    return rc, rows_c, b1_bf16, b1_f32


def dist_part_d(dev, card, walls, P=DIST):
    """Part d: train_mnist.py's MLP, uninterrupted; killed at step 7 and
    resumed; its checkpoint resharded -> (run 1's results, B5's rows)."""
    from mxnet_tpu_torch import checkpoint as ckpt
    from mxnet_tpu_torch.parallel import layout
    n = P["ranks"]
    walls["d1"], _ = dist_launch("d", n, "--max-restarts", "0",
                                 env={"PHASE24_RUN": "run1"})
    root = os.path.join(DIST_DIR, "mnist_ckpt")
    walls["d2"], out = dist_launch(
        "d", n, "--max-restarts", "1", "--restart-backoff", "0.2",
        "--checkpoint-dir", root, "--env",
        "MXNET_FAULT_INJECT=kill@step=%d:rank=0" % P["kill_step"],
        env={"PHASE24_RUN": "run2"})
    if "launch: restarting the group" not in out or \
            "resumed from checkpoint step" not in out:
        raise RuntimeError("part d: no kill and resume:\n%s" % out[-4000:])
    for r in range(n):
        with np.load(os.path.join(DIST_DIR, "mnist_run1_rank%d.npz" % r)) \
                as a, np.load(os.path.join(DIST_DIR, "mnist_run2_rank%d.npz"
                                           % r)) as b:
            for k in a.files:
                if not np.array_equal(a[k], b[k]):
                    raise RuntimeError("part d: rank %d's %s after the "
                                       "resume is not bitwise run 1's"
                                       % (r, k))
    d1 = dist_results("d_run1", n)
    steps = d1[0]["steps"]
    for r in d1:
        if r["fallback"] or r["launches"] != dict(
                dict.fromkeys(r["launches"], 0), scale_bias_act=2 * steps):
            raise RuntimeError("part d: launches %s (want B5 2 a forward "
                               "over %d steps), fallback %s"
                               % (r["launches"], steps, r["fallback"]))
    states, mans, s = ckpt._load_rank_states(root)
    gathered = layout.gather_state(states, layout.LayoutManifest.from_dict(
        mans[0]["meta"]["layout"]))
    rep = ckpt.reshard_checkpoint(root, 1, dst_root=root + "-w1")
    got, man = ckpt.CheckpointManager(root + "-w1", rank=0, world=1,
                                      async_save=False).restore_resharded()
    direct, _ = ckpt.CheckpointManager(root, rank=0, world=1,
                                       async_save=False).restore_resharded()
    for st in (got, direct):
        for k, v in gathered.items():
            if k == "__data_cursor__":
                continue
            same = bytes(v) == bytes(st[k]) if isinstance(v, bytes) else \
                np.array_equal(v, st[k])
            if not same:
                raise RuntimeError("part d: resharded %s is not bitwise the "
                                   "gathered state" % k)
    b5_rows = [b5_row(s_, torch.float32, dev, "train_mnist.py's fc%d, a "
                      "rank of part d" % (i + 1))
               for i, s_ in enumerate(EX["mnist_b5"])]
    for row in b5_rows:
        row["launches"] = sum(r["launches"]["scale_bias_act"]
                              for r in d1) // 2
    log("  (d) train_mnist.py's MLP at dist_sync, %d ranks, %d steps: run 1 "
        "%.1f s; run 2 killed at step %d on rank 0 and resumed by the "
        "launcher from step %s, final weights bitwise run 1's (%.1f s); "
        "B5 2 a forward (%d a rank), no fallback; run 2's checkpoint "
        "resharded 2 -> 1 (step %d, fingerprint %s) and restored by "
        "restore_resharded bitwise the gathered state"
        % (n, steps, walls["d1"], P["kill_step"],
           "/".join(sorted(set(ln.split("step ")[1].split(" ")[0]
                               for ln in out.splitlines()
                               if "resumed from checkpoint step" in ln))),
           walls["d2"], 2 * steps, rep["step"], rep["layout_fingerprint"]))
    return d1, b5_rows


def dist_path(dev, card, report, sites):
    """Phase 24 (see the module docstring) -> the B1 launches of its
    ranks by dtype, B1's checks at batch 64 (bf16, f32) and B5's rows
    with their launches."""
    t_phase = time.perf_counter()
    log("phase 24: multi-process training, two and three ranks on cuda:0 "
        "through the port's launcher (gloo)")
    import shutil
    shutil.rmtree(DIST_DIR, ignore_errors=True)
    os.makedirs(DIST_DIR)
    walls = {}
    dist_part_a(dev, card, walls)
    rb = dist_part_b(dev, card, walls)
    rc, rows_c, b1_bf16, b1_f32 = dist_part_c(dev, card, report, sites,
                                              walls)
    d1, b5_rows = dist_part_d(dev, card, walls)
    wall = time.perf_counter() - t_phase
    log("phase 24 wall: %.1f s (a %.1f, a at 2 ranks and b %.1f, c %.1f, "
        "d %.1f + %.1f)" % (wall, walls["a3"], walls["b"], walls["c"],
                            walls["d1"], walls["d2"]))
    report["dist"] = {"walls": walls, "wall_s": wall, "sparse": rb,
                      "resnet": rows_c, "resnet_ranks": rc, "mnist": d1}
    b1_by_dtype = {
        "bfloat16": {form: sum(r[run]["launches"][form] for r in rc
                               for run in ("ddp_1mb", "ddp_auto",
                                           "ddp_64mb"))
                     for form in ("bn_act", "bn_act_res")},
        "float32": {form: sum(r[run]["launches"][form] for r in rc
                              for run in ("kvstore", "ddp_64mb_f32"))
                    for form in ("bn_act", "bn_act_res")}}
    return b1_by_dtype, b1_bf16, b1_f32, b5_rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--report", help="also write the full JSON report here")
    ap.add_argument("--worker", choices=("a", "b", "c", "d"),
                    help="run one rank of a phase-24 part (the launcher "
                         "starts these)")
    ap.add_argument("--out", help="the phase-24 worker's output directory")
    opts = ap.parse_args()
    if opts.worker:
        return worker_main(opts.worker, opts.out)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log("torch %s (CUDA %s) on %s" % (torch.__version__, torch.version.cuda,
                                      name))
    log(card)
    log("TF32 off for cuDNN convolutions and CUDA matmuls")

    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    log("build: %s in %.2fs" % (", ".join(_build.sources()), build_s))
    for src in _build.sources():
        for line in (_build.build_log(src) or "").splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "wgmma" in line):
                log("  " + line.strip())
    hgmma = {src: hgmma_count(src) for src in ("flash_attn", "flash_fwd")}
    log("HGMMA instructions (cuobjdump -sass): %s" % json.dumps(hgmma))
    for src, n in hgmma.items():
        if n == 0:
            raise RuntimeError("%s has no HGMMA instruction: the flash "
                               "tile does not run on tensor cores" % src)

    report = {"card": card, "device": name, "torch": torch.__version__,
              "build_s": build_s, "hgmma": hgmma}
    sites = fused_sites(resnet50())
    max_err, per_class, totals = kernel_phase(sites, dev)
    host_us = wrapper_host_us(dev)
    log("host time per kernel launch through the wrapper: %.1f us" % host_us)
    # the least time_ms reads for any launch, in each flush mode
    empty = {mode: time_ms(lambda: torch.cuda._sleep(0), dev,
                           clean_l2=mode == "clean")
             for mode in ("dirty", "clean")}
    log("an empty kernel (torch.cuda._sleep(0)) in time_ms: %s ms"
        % json.dumps(empty))
    report.update(kernel_classes=per_class, kernel_totals=totals,
                  wrapper_host_us=host_us, empty_kernel_ms=empty)
    launches = main_path(dev, card, report)
    gpt_err, gpt_rows = gpt_kernel_phase(dev)
    report["decode_kernels"] = gpt_rows
    gpt_launches, plain = gpt_main_path(dev, card, report)
    spec_launches = spec_main_path(dev, card, report, plain)
    del plain
    train_err, train_rows = train_kernel_phase(dev)
    report["train_kernels"] = train_rows
    train_launches = train_main_path(dev, card, report)
    gluon_launches = gluon_main_path(dev, card, report)
    sym50 = resnet50()
    args50, aux50 = draw_params(sym50)
    int8_err, int8_rows, int8_tot = int8_kernel_phase(
        int8_sites(sym50, args50, aux50), dev)
    report["int8_kernels"] = {"classes": int8_rows, "totals": int8_tot}
    int8_launches = int8_main_path(
        dev, card, report, os.path.join(REPO, "build", "chip_smoke",
                                        "resnet50.mxtorch"),
        sym50, args50, aux50)
    del sym50, args50, aux50
    b1t_err, b1t_rows, b1t_tot = b1_train_phase(sites, dev)
    report["train_b1_kernel"] = {"classes": b1t_rows, "totals": b1t_tot}
    train_b1 = resnet_train_path(dev, card, report)
    op_launches, op_err, op_ms = gluon_image_path(dev, card, report, sites,
                                                  b1t_tot, totals)
    grouped_b1, grouped_census = grouped_resnet(dev, card, report)
    grouped_counts = grouped_gpt(dev, card, report)
    grouped_dropout(dev, report)
    reco_rows, reco_launches = recommend_path(dev, card, report)
    rnn_rows, rnn_launches = rnn_path(dev, card, report)
    rec_b1, aug_rows, aug_counts = records_path(dev, card, report)
    loop_b1 = imagenet_path(dev, card, report)
    inc_err, inc_tot, inc_serve, inc_train, inc_census, alex_b5 = \
        vision_path(dev, card, report)
    det_errs, ssd_err, ssd_tot, ssd_train_b1, ssd_detect_b1, rcnn_b5 = \
        detection_path(dev, card, report)
    cifar_b1, cifar_rows, cifar_tot, cifar_err, mnist_b5 = \
        common_ops_path(dev, card, report)
    nce_b2, nce_rows = examples_path(dev, card, report)
    dist_b1, dist_b1_bf16, dist_b1_f32, dist_b5 = dist_path(dev, card, report,
                                                            sites)

    kernels = []
    for form in ("bn_act", "bn_act_res"):
        # B1 on two paths: f32 serving (times summed over a batch-32
        # forward's sites) and bf16 training (over a batch-128 forward's)
        # and its op surface (phase 14), whose calls run the bf16 training
        # shapes among others: phase 12's kernel times are its times
        paths = {"serve": (launches[form], max_err[form + "/float32"],
                           totals["float32/" + form], [32, "float32"]),
                 "train": (train_b1[form], b1t_err[form], b1t_tot[form],
                           [RESNET_TRAIN["bf16_batch"], "bfloat16"]),
                 "_contrib_FusedBNAct": (
                     op_launches[form], op_err[form], b1t_tot[form],
                     [RESNET_TRAIN["bf16_batch"], "bfloat16"]),
                 # phase 15: the same shapes inside the captured graph
                 "grouped": (grouped_b1[form], b1t_err[form],
                             b1t_tot[form],
                             [RESNET_TRAIN["bf16_batch"], "bfloat16"]),
                 # phase 18: the same, fed from the records
                 "records": (rec_b1[form], b1t_err[form], b1t_tot[form],
                             [RESNET_TRAIN["bf16_batch"], "bfloat16"]),
                 # phase 19: train_imagenet.py's loop at K = 1
                 "imagenet_loop": (loop_b1[form], b1t_err[form],
                                   b1t_tot[form],
                                   [RESNET_TRAIN["bf16_batch"], "bfloat16"])}
        if form == "bn_act":
            # phase 20: Inception-v3's 94 sites (no residual form), served
            # in f32 and trained in bf16, each timed at its own shapes
            paths["inception_v3_serve"] = (
                inc_serve[form], inc_err["float32"], inc_tot["float32"],
                [INCEPTION["f32_batch"], "float32"])
            paths["inception_v3_train"] = (
                inc_train[form], inc_err["bfloat16"], inc_tot["bfloat16"],
                [INCEPTION["bf16_batch"], "bfloat16"])
            # phase 21: SSD's four sites, trained (K 1) and in the
            # detection forward, timed at their shapes (batch 8, f32)
            paths["ssd_train"] = (ssd_train_b1, ssd_err, ssd_tot,
                                  [DET["ssd_batch"], "float32"])
            paths["ssd_detect"] = (ssd_detect_b1, ssd_err, ssd_tot,
                                   [DET["ssd_batch"], "float32"])
        # phase 22: train_cifar10.py's ResNet-20, bf16 at batch 128
        paths["cifar10_train"] = (cifar_b1[form], cifar_err,
                                  cifar_tot[form],
                                  [EX["cifar"]["batch"], "bfloat16"])
        # phase 24: ResNet-50's ranks at batch 64 (the DDP runs in bf16,
        # the kvstore path and DDP in f32), each timed at its shapes
        paths["dist_resnet_bf16"] = (
            dist_b1["bfloat16"][form], dist_b1_bf16[0][form],
            dist_b1_bf16[2][form], [DIST["resnet_batch"], "bfloat16"])
        paths["dist_resnet_f32"] = (
            dist_b1["float32"][form], dist_b1_f32[0][form],
            dist_b1_f32[2][form], [DIST["resnet_batch"], "float32"])
        by_path = {p: {"launches": n, "max_abs_err": e, "batch_dtype": bd,
                       "ms": t["kernel_ms"],
                       "ms_clean_l2": t["kernel_clean_ms"],
                       "plain_ms": t["plain_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                       "library_ms": None}
                   for p, (n, e, t, bd) in paths.items()}
        by_path["_contrib_FusedBNAct"]["op_ms_49_sites"] = op_ms
        # the wrapper counts the warm-up and the capture; a profiled
        # replayed window's device census beside it
        by_path["grouped"]["replayed_window_launches"] = \
            grouped_census.get(form, 0)
        if form == "bn_act":
            by_path["inception_v3_train"]["replayed_window_launches"] = \
                inc_census[form]
        main_ = max(by_path.values(), key=lambda b: b["launches"])
        kernels.append({"name": form, "route": "cuda", "source": SOURCE,
                        "replaces": REPLACES[form],
                        "launches": sum(b["launches"]
                                        for b in by_path.values()),
                        "max_abs_err": max(b["max_abs_err"]
                                           for b in by_path.values()),
                        **{k: main_[k] for k in TIME_KEYS},
                        "by_path": by_path})
    for kname in ("take_rows", "flash_attn", "flash_attn_paged"):
        # the decode path's kernels, two of them also on the training
        # path: launches summed over the paths, the worst error, and the
        # times at the shape of the path that launched the kernel most;
        # each path's own numbers under "by_path"
        paths = {"generate": (gpt_launches[kname],
                              gpt_err[kname + "/float32"], gpt_rows[kname])}
        # the speculative path: its own verifier shape for B4, the
        # generate path's prefill and gather shapes for B3 and B2
        verify = kname == "flash_attn_paged"
        paths["speculative"] = (
            spec_launches[kname],
            gpt_err[kname + ("@verify" if verify else "") + "/float32"],
            gpt_rows[kname + ("/verify" if verify else "")])
        if kname in train_launches:
            paths["train"] = (train_launches[kname],
                              train_err[kname + "@train/float32"],
                              train_rows[kname + "@train"])
        if kname in gluon_launches:
            # the Gluon path runs the training path's shapes: phase 7's
            # check and times at those shapes are its numbers too
            paths["gluon"] = (gluon_launches[kname],
                              train_err[kname + "@train/float32"],
                              train_rows[kname + "@train"])
        if grouped_counts.get(kname):
            # so does phase 15's grouped GPT (the graph's warm-up and
            # capture through the wrapper)
            paths["grouped"] = (grouped_counts[kname],
                                train_err[kname + "@train/float32"],
                                train_rows[kname + "@train"])
        if kname == "take_rows":
            # phase 16: the served lookup (a 1024-row cache by 16 x 64
            # slots at most) and the matrix factorization's embeddings,
            # each timed at its own shape; bitwise, so no error
            paths["recommend"] = (reco_launches["recommend"], 0.0,
                                  reco_rows["take_rows@serve"])
            paths["matrix_factorization"] = (
                reco_launches["matrix_factorization"], 0.0,
                reco_rows["take_rows@mf"])
            # phase 17: the encoders of the recurrent paths
            for p_ in ("lstm_bench", "word_lm", "char_lstm"):
                paths[p_] = (rnn_launches[p_], 0.0,
                             rnn_rows["take_rows@" + p_])
            # phase 23: nce_word2vec.py's two lookups a step, timed at
            # the candidates' (256, 16) ids
            paths["nce_word2vec"] = (nce_b2, 0.0,
                                     nce_rows["take_rows@nce_cands"])
        by_path = {p: dict(launches=n, max_abs_err=e, shape=r["shape"],
                           **{k: r[k] for k in NAMED_KEYS if k in r})
                   for p, (n, e, r) in paths.items()}
        main_ = max(by_path.values(), key=lambda b: b["launches"])
        kernels.append({"name": kname, "route": "cuda",
                        "source": GPT_SOURCES[kname],
                        "replaces": GPT_REPLACES[kname],
                        "launches": sum(b["launches"]
                                        for b in by_path.values()),
                        "max_abs_err": max(b["max_abs_err"]
                                           for b in by_path.values()),
                        **{k: main_[k] for k in NAMED_KEYS if k in main_},
                        "by_path": by_path})
    for kname in ("scale_bias_act", "flash_fwd"):
        r = train_rows[kname]
        err = train_err[kname + "/float32"]
        entry = {"name": kname, "route": "cuda",
                 "source": TRAIN_SOURCES[kname],
                 "replaces": TRAIN_REPLACES[kname],
                 "launches": train_launches[kname], "max_abs_err": err,
                 **{k: r[k] for k in NAMED_KEYS if k in r}}
        # B7 on both training paths (tier off), B5 on Module.fit's and
        # phase 15's grouped GPT, at the same shape; B5 also at AlexNet's
        # fc6 and fc7 (phase 20), f32 and bf16, each timed at its shape
        more = [(p, n[kname], err, r) for p, n in (
            ("gluon", gluon_launches), ("grouped", grouped_counts))
            if n.get(kname)]
        if kname == "scale_bias_act":
            more += [("alexnet_train/" + dt, row["launches"],
                      row["max_abs_err"], row)
                     for dt, row in sorted(alex_b5.items())]
            # phase 21: R-CNN's fc6, once a forward (automatic K and K 4)
            more.append(("rcnn_train", rcnn_b5["launches"],
                         rcnn_b5["max_abs_err"], rcnn_b5))
            # phase 22: train_mnist.py's fc1 and fc2, once a forward each
            more += [("mnist_train/fc%d" % (i + 1), row["launches"],
                      row["max_abs_err"], row)
                     for i, row in enumerate(mnist_b5)]
            # phase 24: the same MLP in two ranks at dist_sync (run 1)
            more += [("dist_mnist/fc%d" % (i + 1), row["launches"],
                      row["max_abs_err"], row)
                     for i, row in enumerate(dist_b5)]
        if more:
            entry["by_path"] = {
                p: dict(launches=n, max_abs_err=e, shape=row["shape"],
                        **{k: row[k] for k in NAMED_KEYS if k in row})
                for p, n, e, row in [("train", train_launches[kname], err,
                                      r)] + more}
            entry["launches"] += sum(m[1] for m in more)
            entry["max_abs_err"] = max([err] + [m[2] for m in more])
        kernels.append(entry)
    kernels.append({"name": "int8_dequant", "route": "cuda",
                    "source": INT8_SOURCE, "replaces": INT8_REPLACES,
                    "launches": int8_launches,
                    "max_abs_err": max(int8_err.values()),
                    "ms": int8_tot["kernel_ms"],
                    "plain_ms": int8_tot["plain_ms"],
                    "bound_ms": int8_tot["bound_ms"],
                    "bound_by": int8_tot["bound_by"], "library_ms": None})
    for kname in ("image_aug", "jpeg_color"):
        # phase 18's kernels (no TPU counterpart: the JAX package decodes
        # and augments on the host); bitwise their plain versions
        r = aug_rows[kname]
        kernels.append({"name": kname, "route": "cuda",
                        "source": AUG_SOURCES[kname],
                        "replaces": AUG_REPLACES[kname],
                        "launches": aug_counts[kname], "max_abs_err": 0.0,
                        "shape": r["shape"],
                        **{k: r[k] for k in TIME_KEYS}})
    report["kernels"] = kernels
    report["detection_ops_max_abs_err"] = det_errs
    report["wall_s"] = time.perf_counter() - t_run
    log("whole run: %.1f s of wall time, the kernels' build included"
        % report["wall_s"])
    if opts.report:
        os.makedirs(os.path.dirname(os.path.abspath(opts.report)),
                    exist_ok=True)
        with open(opts.report, "w") as f:
            json.dump(report, f, indent=1, default=str)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
