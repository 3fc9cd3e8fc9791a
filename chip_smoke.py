#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's training and serving paths on one NVIDIA
GPU and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   -- the card (``nvidia-smi`` name and power limit, torch, CUDA).
2. build    -- compiles every CUDA kernel library from ``csrc/`` (one nvcc
               per library, sm_90a, all started together; K1 and K2 one
               library per padded head width, 64, 128 and 256, and one for
               every wider head, the column-chunked kernels) and reports
               the seconds taken, per library too, and ptxas's register /
               spill lines; for each kernel of ``csrc/flash_tc.cuh`` (K1's
               forward, dK/dV and dQ, bf16/f16, 64/128/256 wide: 18, and
               K2's bf16/f16 instances of the same bodies: 18) and each of
               K2's 3xTF32
               forward, dK/dV and dQ kernels (64/128/256: 9) its
               registers, spills, ptxas's performance notes (K1: its
               dynamic shared memory), and, where ``cuobjdump`` is found,
               its count of HGMMA (wgmma) instructions, which must be above
               0; the split decode kernel's (K3) ptxas notes; and K4's
               kernels' registers, spills, ptxas notes and HGMMA counts
               (above 0 for each of its 8 tensor-core instances: bf16/f16,
               int8/fp8, walk/split; 0 for the 8 f32 CUDA-core ones); and
               the same for the 5 forwards past 256 on the tensor cores
               (``fwd_tc`` bf16/f16 for K1 and K2, ``fwd_tc_f32``; HGMMA
               above 0), the 8 dK/dV and dQ kernels past 256
               (``dkdv_tc``, ``dq_tc``, bf16/f16 for K1 and K2; HGMMA
               above 0), K2's f32 dK/dV and dQ past 256 (``bhd_dkdv_tc<0>``,
               ``bhd_dq_tc<0>``; HGMMA above 0) and K3's prefill kernel
               past 256 and, since the rebuild of the chunks up to 256,
               K3's bf16/f16 prefill kernel at every D on wgmma
               (``paged_attention_tc<T, chunk, consumers, producer>``: 20
               instances, TMA and gathered; HGMMA above 0), K3's f32
               prefill kernel (``paged_attention_tf32<DP, consumers,
               producer>``: 12 instances; HGMMA above 0) and the split
               decode kernel's TMA and gathered instances.
3. flash    -- holds the three packed flash-attention kernels (forward, dK/dV,
               dQ; ``csrc/flash_attention_packed.cu``) against their plain
               PyTorch versions run in f32 on the same bf16/f16 inputs:
               forward O and LSE, and the gradient through
               ``FlashAttentionPacked``.  Cases: causal and non-causal,
               dropout 0.1 with a fixed seed, the training geometry (b=4,
               s=1024, H=12, D=64), ragged s=1000 with H=2, f16, head widths
               32 and 128, widths 40 and 80 (zero-filled padding columns),
               s=65 (one row in the last tile), batch 1 on a strided view, and
               the widest instances at H=2: D=256 (bf16, f16 non-causal,
               dropout 0.1) and D=192 (also ragged s=200); past 256 the
               column-chunked forward and backward on the tensor cores
               (``fwd_tc``, ``dkdv_tc``, ``dq_tc``; each case names its
               backward kernel) at D=320, 384, 512 (H=1; H=2 non-causal
               with dropout 0.1) and 1024, in bf16 and f16 (f16 at 384
               with dropout), each
               past 256 also running the forward twice more bit for bit
               and on a qkv whose V chunks repeat (every output chunk of
               a row must equal the first bit for bit: one max and sum a
               row); b*H = 65538 (past a grid's y
               limit) at D=64 and 320, whose last batches are held against
               the plain version with the batches before as the planted
               fault; D=64 f16 and D=128
               bf16 take the in-tile scale path, the bf16 D=64 and D=256 cases
               the folded one (``scale_path``).  Then the timed kernels' own
               results at b=32, s=1024.  Limits (``FLASH_TOL``), per slice of
               the result (O, dQ, dK, dV): relative L2 error 1e-2 and worst
               row 0.2; LSE absolute 2e-3.  Each case also reads a control
               (the plain version in bf16/f16, which must pass), a planted
               fault (a stale kv tile, which must fail), and runs the backward
               twice more: the three dqkv must be bit-identical (as at the
               timing shape).  Then times each kernel at b=32, s=1024, H=12,
               D=64 by CUDA-graph replay, beside its bound, its plain version
               and the library yardstick
               ``F.scaled_dot_product_attention(is_causal=True)`` on pre-split
               (b, H, s, D) tensors (forward by graph replay; backward, for
               dK/dV and dQ together, by the kernels' own device time under
               ``torch.profiler``), which the port never calls; the
               backward pair beside SDPA's backward (``backward_pair``;
               K2's bf16 kernels, the same bodies, in ``flash_bhd``).
               Then the same three kernels at D=256
               (b=8, s=1024, H=4: the wide GPT's attention) beside their
               bounds, plain versions and SDPA's bf16 forward and backward
               (``wide``).
4. train    -- GPT-2-small (12 layers, hidden 768, 12 heads, vocab 50304)
               with Normal(0, 0.02) weights from a numpy seed, dropout 0,
               through ``make_sharded_train_step(param_dtype=bf16,
               learning_rate=1e-4, grad_clip_norm=1.0)`` at b=32, s=1024
               on one repeated batch of random ids and labels: 2 warm-up
               steps, then 10 timed steps.  Gates: every loss finite, the
               loss after the 10 steps below the first, each flash launch
               count exactly 10 x 12 over the timed steps.  Then a 3-step
               loss series at b=4 with use_flash_attention=True against the
               same model and init with use_flash_attention=False (the
               plain composition), rtol 1e-3 (they have agreed to 2.6e-5
               on the H100: a 40x margin for bf16 rounding in attention).
               Reports the peak device memory over the timed steps (the
               loss keeps no f32 copy of the logits).
5. train_profile -- one train step under ``torch.profiler``: device idle
               share, kernel launches (copies and sets apart), top device
               kernels and host ops.
6. train_optim -- GPT-2-small in bf16 (the same weights) at b=8, s=1024,
               3 steps each on one repeated batch through (a)
               ``make_functional_train_step`` with AdamW (biases and layer
               norms spared by ``apply_decay_param_fun``), ``LinearWarmup``
               over ``CosineAnnealingDecay`` and ``ClipGradByGlobalNorm(1.0)``;
               (b) ``make_sharded_train_step(optimizer="lamb")``; (c)
               ``make_sharded_train_step(master_weights=True)``.  Gates per
               run: losses finite and falling, each K1 kernel launched
               exactly 3 x 12 times, no call of K1's plain versions.  Then
               (``train_optim_adam_bits``) two steps of Adam and of AdamW on
               (c)'s bf16 parameters and gradients: the multi-tensor update
               and the per-tensor rule must give the same bits, values and
               moments (wall time of each beside); and
               (``train_optim_loss``) the chunked loss on the model's logits
               against the unchunked logsumexp form: mean within 1e-6
               relative, each gradient entry within 1 bf16 ulp (peak memory
               and wall time of each form beside).
7. flash_bhd_checks -- holds the three bhd flash-attention kernels K2
               (forward, dK/dV, dQ; ``csrc/flash_attention.cu``) against their
               plain versions on the same inputs: f32 against the plain
               version in f64, bf16/f16 against it in f32; forward O and LSE,
               and the gradient through ``FlashAttentionBHD``, each slice
               apart.  Cases: causal and non-causal, dropout 0.1 with a fixed
               seed, sq=256/skv=1024 and sq=1024/skv=256 causal, ragged
               s=1000, D = 32, 80, 128, 256 and 36 (rows not 16-byte aligned
               in bf16/f16, zero-padded to 40) and, past 256, 264, 320,
               384, 512 and 1024,
               each in f32, bf16 and f16 (the forward on the tensor cores;
               each also twice more bit for bit and with V's chunks
               repeated, every output chunk equal to the first; bf16/f16
               dK/dV and dQ on the tensor cores, the pair twice more bit
               for bit); every bf16/f16 case up to 256 launching only
               ``flash_tc.cuh``'s forward, dK/dV and dQ (``fwd_tc16``,
               ``tc16``) and no other kernel, its forward and its pair
               three times each bit for bit alike (the pair also equal to
               autograd's); bf16 D=100 (padded to 104) with dropout 0.1
               and sq=256 < skv=512 (causal kv blocks past the last q row
               write zeros); bf16 D=320 and D=264 (sq > skv) and f16 D=512
               (non-causal, sq < skv) with dropout 0.1; rows TMA cannot
               address, zero-padded onto the tensor-core kernels: f32 D=33
               (the 3xTF32 kernels at 36) and bf16 D=514 (at 520); f32 at
               D=1032 (a last 128-column chunk of 8), at D=264 with dropout
               and sq != skv, at D=512 with dropout and sq > skv, and at
               D=514, each f32 case past 256 launching the tensor-core
               forward and the 3xTF32 dK/dV and dQ (at 516 for D=514) and
               no other kernel; the
               Python mirror of the routes and dynamic shared memory
               (``fwd_route``, ``bwd_route``, ``tc16_smem``,
               ``wide_fwd_plan``, ``fwd_plan``, ``bwd_plan``) equal to the
               libraries' own at widths 33 to 8192; the f32 training
               geometry (B*H = 16*12, s=1024, D=64); batch 1 through
               ``flash_attention_bshd`` on strided views of one fused
               projection (f32 at H=12, s=1024; bf16 at H=1); and the ring's
               unit: ``_bwd_pair`` over kv halves with the global LSE and Δ
               (non-causal: dq sums, dk/dv concatenate; causal: the two-device
               ring layout); and b*H = 65538 (past grid.y's limit) at s=8,
               D=64, f32 and bf16, forward and pair, whose last two heads
               are held against the plain version with the heads before as
               the planted fault (bf16: ``flash_tc.cuh``'s kernels alone,
               once each, and twice more bit for bit).  Limits: bf16/f16 ``FLASH_TOL``; f32
               ``FLASH_F32_TOL`` (relative L2 1e-4, worst row 2e-3, LSE 1e-5),
               which TF32 products fail.  Each case reads a control (the plain
               version in the input's dtype, must pass) and a planted fault (a
               stale kv tile, must fail); each f32 case also the plain version
               on operands rounded to TF32 (must fail), and runs the forward
               twice more, bit for bit the same; at D <= 256 with rows TMA
               addresses (the 3xTF32 forward) it reads O's error beside the
               plain forward on 3xTF32 operands split to nearest and by
               truncation.  Each f32 case runs
               the dK/dV + dQ pair (3xTF32 on the tensor cores) three times
               more: bit for bit the same; beside it the plain pair on
               3xTF32 operands split to nearest and split by truncation.
               Below D = 1024 (to 512, and 514 padded to 516) the pair
               is held to ``FLASH_F32_PAIR_REL`` (relative L2 6e-7 on dq,
               dk and dv against f64) and the truncated control must fail
               it; the split to nearest is read (its own f32 sums over
               3 D-long and 1000-row contractions reach 7.9e-7).
8. flash_bhd -- K2's times at the f32 training geometry by CUDA-graph
               replay (inputs 201 MB), beside the bounds (as 3xTF32, three
               tf32 products at 494.7 TFLOP/s, with the f32 CUDA-core
               bound, 67 TFLOP/s, beside), the forward's and the pair's
               error against f64 beside SDPA's, the pair's repeats bit for
               bit, the plain versions,
               and the library
               yardstick ``F.scaled_dot_product_attention(is_causal=True)``
               on (b, H, s, D) f32, pinned to the efficient-attention
               backend, with its error against the f64 plain version;
               then the bf16 instance beside K1 at K1's timing shape; then
               K2's bf16 kernels up to 256 (``flash_tc.cuh``) at D=64
               (b=32, H=12), 128 (b=16, H=8) and 256 (b=8, H=4), s=1024,
               causal, each beside its bound, its plain version and SDPA's
               bf16 forward or backward, with its largest error against
               the plain version, and at D=64 their launches over three
               passes through ``flash_attention`` (only ``fwd_tc16`` /
               ``tc16``, 3 each); then the f32 kernels at
               D=256 (b=8, s=1024, H=4) beside their bounds, plain
               versions and SDPA (``wide``); the pair's error
               against f64 beside SDPA's own f32 backward's.
9. train_f32 -- GPT-2-small f32 (``make_sharded_train_step`` with no
               ``param_dtype``: f32 parameters and Adam moments) at b=16,
               s=1024, flash on auto: 2 warm-up and 10 timed steps.  Gates:
               losses finite and falling, K2 launches exactly 10 x 12 each,
               K1 launches 0, no plain K2 call.  Then one profiled step
               (``train_f32_profile``: idle share, K2's share of busy
               time) and a 3-step loss series at b=4, K2 against
               ``use_flash_attention=False`` (the plain composition), rtol
               ``F32_FLASH_VS_PLAIN_RTOL``.
10. wide     -- a GPT at D = 256 (hidden 1024, 4 heads, 2 layers), b=4,
               s=1024, 3 train steps each way: bf16 through K1, f32
               through SDPA and K2.  Gates: the flash series' launches
               exactly 3 x 2 per kernel, also by kernel (the forward,
               dK/dV and dQ its width runs 3 x 2 each, every other 0),
               the other family's and the plain versions' calls 0, and
               its loss series against
               the plain composition's within ``FLASH_VS_PLAIN_RTOL``
               (bf16) and ``F32_FLASH_VS_PLAIN_RTOL`` (f32).
9b. wide512 -- the same at D = 512 (hidden 1024, 2 heads, 2 layers, b=2,
               s=1024): K1 through the column-chunked kernels on the
               tensor cores (``dkdv_tc`` and ``dq_tc`` 3 x 2 each, K1's
               other backward kernels 0), K2 f32 through the forward and
               the 3xTF32 dK/dV and dQ on the tensor cores.  Then
               (``wide512_times``) those kernels timed at its attention
               (b=2, H=2, s=1024, D=512; K2 f32, K1 bf16), each timed
               forward and pair held against its plain version, K2's
               bf16 forward and pair at the same shape (the pair's
               launches counted over three passes through
               ``flash_attention``), K2's f32 forward at D=514 (padded to
               516, the pad copies timed apart), and K3 at D=512 (width 1 in
               bf16, f16 and f32: the split kernel in column slices; width
               32 in bf16; each held against its plain version at 2e-2,
               f32 2e-5), each beside its plain version, SDPA and its
               bounds.
9c. dispatch_repairs -- each dispatcher on the card with what its kernel
               refuses: K1 a strided qkv, K3 an int64 page table and
               lengths, K4 a transposed weight view and a bf16 scale; each
               launches its kernel and equals the normalised call bit for
               bit.
11. paged   -- holds ``paged_attention`` (K3: the split decode kernel at
               widths below 16 at any D, past 256 its row in column
               slices, its rows by whole-page TMA boxes where they are a
               multiple of 16 bytes, else gathered; prefill chunks the
               bf16/f16 kernel on wgmma, ``paged_attention_tc``, and the
               f32 kernel on 3xTF32 wgmma, ``paged_attention_tf32``, each
               on TMA boxes where D's rows are a multiple of 16 bytes over
               pages of a multiple of 8 rows, else on gathered rows)
               against its plain PyTorch version
               (``paged_attention_ref``) at the serving geometry (B=16,
               H=12, D=64, P=16, maxp=32; widths 1 and 32; shuffled page
               tables, an inactive slot, lengths 0 / page boundary / last
               row of the table; and the serving run's own pool, tables
               and lengths), and past the old limits: widths 65, 128 (pages
               of 128) and 256 (pages of 256), width 1 over pages of 128,
               D=36, and D=320 and 512 at widths 1 and 32 over 8-page
               tables, bf16 width 32 at D=512 over pages of 128 and of 48
               and at D=260 (gathered); the bf16/f16 chunks up to 256 at
               D = 8, 40, 64, 128, 256, widths 16 to 200 (one and two
               consumer warpgroups), pages of 8, 16, 48 and 128, and
               beside them pages of 12 and 5 and D = 36 and 33 on the
               gathered instance; the f32 chunks at D = 128 and 256 and
               past 256 (D = 320 and 512), over pages of 48, 8, 12 and 6
               and at D = 38 and 33 (gathered); the split decode's gathered
               instance at D = 36 (bf16/f16, widths 1 and 15, pages of 16
               and 12), D = 33 (bf16, f32) and past 256 at D = 260 (bf16)
               and 257 (f32); each launching the kernel ``tile_route``
               names and no other, twice more bit for bit, beside a control
               (the plain version in the inputs' dtype, must pass) and a
               planted fault (each slot's first page read from its second,
               must fail); the route and plan mirrors (``tile_route``,
               ``tc_plan``, ``tf32_plan``, ``split_plan``) equal to the
               library's own at every dtype, width 1-128, D 4-1032 and
               pages of 1-128 rows: bf16 against an f32 run of the plain
               version at atol=rtol=2e-2, f32 at 2e-5 with TF32 off.  The
               TMA and gathered instances of each chunk kernel at a shape
               both take (bf16 and f32, pages of 16, D=64, width 32) bit
               for bit, and the planted fault (the gathered instance of a
               second build, ``K3_UNSWIZZLED``, whose tiles are written
               without the swizzle's XOR) differing.  Then the split decode
               kernel at widths 1 and 15, pages of 16, 128
               and 512, D = 64, 128 and 256, in bf16, f16 (its control the
               f32 result rounded to f16: f16 cannot hold the -1e30 mask)
               and f32, and past 256 at D = 264, 320, 512 and 1024 (column
               slices); 65538 slots
               of one page each (widths 1 and 16, bf16
               and f32: the last two slots against the plain version, the
               two before as the planted fault), and of two pages of 12
               (the gathered chunk routes) and at D = 36 (the gathered
               split decode); and the split decode's summation order:
               three runs bit for bit, each of 16 slots alone bit for bit
               as among the 16 (the fault: a slot alone against its
               neighbour must differ), on the TMA and the gathered
               instance.  Times the kernel, the plain version and
               ``F.scaled_dot_product_attention`` on the gathered
               contiguous K/V (a yardstick the port never calls) at the
               serving run's decode and chunk inputs and at the table's
               full length, by CUDA-graph replay over input copies larger
               than the L2, beside the byte bound; and at width 128 over
               pages of 128 beside its bound, plain version and SDPA with
               the offset-causal mask over the gathered K/V; the f32
               prefill kernel likewise at the serving chunk and at width
               128 over pages of 128 (SDPA in f32, TF32 off; bound: bytes
               or 3xTF32 products); the bf16 chunk at D = 128 and 256
               (widths 32 and 128), the f16 serving chunk, and the shapes
               the retired kernels ran (pages of 12, D = 36, D = 260, f32
               D = 320, f32 pages of 12, f32 D = 38, decode at D = 36),
               each checked and timed beside its bound and SDPA.
12. serving -- GPT-2-small in bf16 through
               ``ServingEngine(cache_mode="paged", max_slots=16, max_len=512,
               page_size=16, num_pages=257, chunk=32, decode_window=32)``:
               16 greedy requests of 64 prompt tokens and 128 new tokens.
               Every request must finish, the split decode kernel's launch
               count must equal the decode steps times the layers and
               ``paged_attention_tc``'s (``tiles_tc``) the chunk ticks times
               the layers, every other K3 kernel and the plain version
               must not be called, and the pool must drain.  Then
               an f32 run of 4 requests x 32 new tokens must be
               token-exact against the dense engine (the plain static-cache
               path), or diverge only at a logit margin <= 1e-3, its chunk
               ticks x layers launching the f32 prefill kernel, its decode
               steps x layers the split kernel, every other K3 kernel and
               the plain version never.
13. profile -- device time by kernel over one short serving run
               (``torch.profiler``), for the breakdown in PERF.md, with
               K3's kernels' share of the busy time.
14. paged_wide -- the paged engine at ``chunk=128, page_size=128`` against
               the dense engine, GPT-2-small f32, 4 requests of 300, 200,
               150 and 64 prompt tokens x 32 new: token-exact, the f32
               prefill kernel launched exactly chunk ticks x layers and the
               split kernel decode steps x layers, every other K3 kernel and
               the plain version never, no page in use after the run.
13b. paged_wide512 -- the paged engine at the wide512 GPT's heads (D =
               512), bf16, ``chunk=32``, pages of 16, 8 requests of 64 + 16
               tokens: K3's prefill kernel past 256 launched exactly chunk
               ticks x layers, the split kernel decode steps x layers,
               every other K3 kernel and the plain version never, no page
               in use; against the dense engine token-exact or diverging
               first within ``BF16_MARGIN`` of the dense model's own
               logits.
13c. paged_p12 -- the paged engine over pages of 12 rows (a box of 4 rows:
               no TMA box takes them), GPT-2-small (12 layers, hidden 768,
               12 heads of 64, N(0, 0.02) weights from a numpy seed), 16
               slots, ``chunk=32``, in bf16 and in f32, 8 requests of 64 +
               32 tokens, counts set to 0 just before and read just after:
               the gathered chunk kernel (``tiles_tc_g``, ``tiles_tf32_g``)
               launched exactly chunk ticks x layers, the split decode
               kernel decode steps x layers, every other K3 kernel and the
               plain version 0 times, no page in use; against the dense
               engine token-exact, or diverging first within the dense
               model's own logit margin (bf16 ``BF16_MARGIN``, f32 1e-3).
15. quant_checks -- holds the dequant-GEMM kernel K4
               (``csrc/quant_matmul.cu``) on the card against its plain
               version ``quant_matmul_ref`` (an f32 sum) and against the
               exact sum rounded once to f32 (``exact_sum``): the four
               GPT-2-small projections (K, N) = (768, 2304), (768, 768),
               (768, 3072), (3072, 768) and (640, 384) x M in {1, 8, 16,
               17, 64, 200, 256, 1024} x int8 / fp8-e4m3 weights
               (quantized by ``nn.quant.quantize_array``), bf16
               activations; the reading is the largest error in bf16 ulps,
               limit 1 (the JAX contract), each output's ulp floored at its
               f32 accumulation noise (``sum_noise``: outputs that cancel
               to near zero), with the raw reading beside it.  Each case
               also reads a control (the plain version with K summed in
               reverse 128-row chunks, which must pass) and a planted
               fault (the kernel on a weight whose second 128-row K tile
               is a copy of its first, which must fail).  Every case is
               held to the exact sum; the four projections at M in {1, 8,
               200, 256} also to the plain version (the f32 plain version
               is itself past one ulp of the exact sum in some of the
               other cases).  Row 0 and row 255 of M = 256 computed alone,
               the 8 rows of an M = 8 batch (the decode split) and the
               rows of the batch inside a batch of 1024 (the walk) must
               equal their rows of the M = 256 batch, bit for bit, and
               three repeats of each must equal the first.  f32
               activations (the CUDA-core kernel) at the same five shapes x
               M in {1, 8, 17, 256, 1024}, int8 and e4m3: within 1e-5 of
               max|exact| (the exact products in f64 times the scale),
               beside a control (the plain version in reverse chunks) and
               a planted fault (a stale K tile), every M's rows bit for bit
               their rows of M = 1024, three repeats bit for bit.  f16
               activations, 1 f16 ulp of the exact sum: M = 8 at (768,
               2304), and M = 256 at every shape with its rows of M = 8 bit
               for bit, int8 and e4m3 weights, each beside a control (the
               exact products in reverse chunk order, must pass) and a
               planted fault (a stale K tile, must fail).  A 3-D input
               with bias through ``quant_matmul``.
16. quant   -- K4's time at M = 8 and M = 256 (bf16 activations, and
               f32 activations) for each projection, and each
               layer's sum, by CUDA-graph replay over input copies larger
               than the L2 (> 60 MB, >= 24 copies), beside its bound, the
               plain version's time and the yardsticks the port never
               calls: ``torch._weight_int8pack_mm`` (where this torch runs
               it for the activation type) and cuBLAS on the widened
               weight in the activation type; where the plan splits at M
               = 256 (out, fc_out), the walk's time beside it, and the
               two results bit for bit.
17. serving_int8 -- the JAX package's ``serving_int8`` row on the card:
               GPT-2-small bf16 with Normal(0, 0.02) weights from a numpy
               seed, ``save_for_serving(quant="int8")`` into a temp dir,
               ``load_for_serving`` on CUDA, a dense
               ``ServingEngine(max_slots=8, max_len=224, chunk=32,
               decode_window=32)``, 8 greedy requests of 64 + 128 tokens;
               alternated with the same bf16 model unquantized, 3 pairs,
               medians of each.  Checks: every request completes, K4's
               launches equal 48 x the model forwards, the plain version
               is called 0 times.  Weight bytes (params + scales +
               buffers) of both.  Then one profiled int8 run (idle share,
               K4's share of device time).
18. quant_f32_cross_check -- int8 and fp8 artifacts of the f32 model: the
               dense and paged engines token-exact against the same
               quantized model's greedy ``generate`` on the card, 4 requests
               x 32 new tokens; the f32 kernel's launches counted.
19. spec    -- speculative decoding (spec_k = 8, the JAX bench's
               ``decode_spec`` and ``serving_spec`` rows) on GPT-2-small
               bf16: (a) ``generate`` at batch 8, prompt 64, 128 new
               tokens, n-gram drafter; (b) the dense engine (8 streams,
               max_len 224, chunk 32, window 32, a repeated prompt among
               the 8); (c) the same paged over pages of 16; (d) the same
               through the serving_int8 phase's int8 artifact; (e) (b) with
               a 2-layer ``ModelDrafter`` at the same width and vocab (the
               target's embeddings and first two blocks).
               Each token-exact against the same path without spec;
               tokens/s of both (median of 3 alternated pairs), acceptance
               rate, spec ticks; launches exact (12 ``paged_decode_split``
               a paged verify tick, 48 K4 an int8 verify tick), 0 plain
               calls, no page left in use; the paged engine's steady-state
               ticks under ``forbid_host_transfers()`` with a planted
               ``.item()`` that must raise.  The paged phase holds K3 at
               the verify width 9 (bf16 and f32) and times it at the
               spec engine's geometry; quant_checks holds K4 at M = 72 and
               quant times it.
20. stages  -- the engine's scheduler stages on GPT-2-small bf16, the paged
               engine at the serving geometry (16 slots, max_len 512,
               pages of 16, chunk 32, window 8) over 129 pages: a mixed
               load of 24 batch requests (64 + 128) and, 16 ticks later,
               8 interactive ones (64 + 64, streamed through
               ``on_token``), once all default and twice with the
               classes: preemptions > 0, interactive TTFT p50 below the
               batch's, the two class runs token-exact, the streams equal
               to the results; whether a replayed row is bit-identical
               to its first pass; 4 sessions x 3 turns; ``defrag()``
               moving pages, then a turn token-exact against the run
               without it; a deadline abort freeing its pages, exact
               against the run without it; an ``auto_run`` burst from 4
               threads ending in ``drain``, beside the same requests
               step-driven; an n-gram spec engine preempted and resumed;
               the int8 artifact on the dense engine with a preemption.
               Every stream against the same request alone (or a fresh
               whole conversation, or the step-driven run) token-exact or
               diverging first within ``BF16_MARGIN`` of the model's own
               logits; K3's and K4's launches exact in every counted run,
               0 plain calls, no page left in use; ``load_report()``
               printed; tokens/s, TTFT p50 by class, preemptions, replayed
               rows, defrag pages and seconds, loop against step tokens/s.

deploy (the deployment surface over the engine, GPT-2-small bf16 with
               N(0, 0.02) weights from a numpy seed): (a) bf16 and int8
               ``save_for_serving`` artifacts through ``create_predictor``
               at 4 x 1024, zero-copy and convenience runs and ``clone``,
               the bf16 logits bit for bit the model's own forward, the
               int8 logits within ``INT8_LOGIT_BOUND`` of the same int8
               model with K4's plain version, and no further from bf16
               than that plain version plus the bound (f32 beside), a
               ``PredictorPool`` of 4 allocating under 1% of the weight
               bytes more than one predictor,
               K1's forward 12 and K4 48 launches a run; (b) the 48
               projections wrapped in ``QuantizedLinear`` (channel-wise),
               3 AdamW steps at 8 x 1024 (K1's three kernels exact, losses
               finite), ``convert_to_weight_only`` (scales the learned
               absmax / 127 bit for bit, weights on the grid), the
               artifact round trip, 8 requests of 64 + 128 on the dense
               int8 engine against the converted model's own ``generate``
               (margin gate, K4 exact); (c) two paged replicas (16 slots,
               pages of 16, chunk 32) behind ``FleetRouter``, 32 requests
               of 64 + 128 (16 sharing a 48-token prefix) against one
               engine alone: a plain run, a failover drill
               (``serving.tick[<replica>]`` failing every tick once the
               first wave has started: its started requests raise
               ``StreamInterruptedError``, the second wave fails over), a
               drain under load losing nothing, affinity against
               round-robin (a higher prefix-hit ratio); K3 counted per
               replica, 0 plain calls, no page left in use; tokens/s and
               TTFT p50 beside one engine's; (d) the native shim and a C++
               client built with g++, 4 threads through
               ``pht_engine_generate`` on the int8 artifact against the
               Python engine (margin gate), the error paths' strings.

dygraph (the Paddle dygraph surface, GPT-2-small bf16 on ``Layer`` with
               N(0, 0.02) weights from a numpy seed, b=8, s=1024): 7
               Adam steps (2 warm-up, 5 timed) through ``paddle.to_tensor``
               / ``model(ids)`` / ``F.cross_entropy`` / ``backward`` /
               ``opt.step`` / ``opt.clear_grad`` with
               ``ClipGradByGlobalNorm(1.0)``, beside the same 7 steps
               from the same weights and batches through
               ``make_sharded_train_step``: both loss series (the idiom's
               bf16 loss, and the step's f32 loss formula on the idiom's
               logits), bit for bit or the first differing step, its
               relative gap (at most ``DYGRAPH_REL_GAP``) and the op that
               reorders; ms/step, device busy time, idle share and peak
               memory of both; K1's launches by kernel (12 fwd, 12 dkdv,
               12 dq a step), 0 plain calls; ``paddle.to_tensor`` with no
               place landing on ``cuda:0``; every ``OP_TABLE`` op on a
               CUDA ``Tensor`` against the same op on a CPU ``Tensor``
               (``tests/test_torch_op_cases.py``: f32 rtol 1e-5, linalg
               by invariants, random ops by shape, dtype and range).
fit (``Model.fit`` and the input pipeline, GPT-2-small bf16 on the
               dygraph phase's weights and batches, b=8, s=1024, fed by
               ``DataLoader(num_workers=2, use_buffer_reader=True)`` over
               an ``io.Dataset`` of the batches' rows: the native staging
               ring's iterator must be the one that ran): the eager fit (7
               steps) against the Paddle idiom run in the same process,
               losses and final weights bit for bit; the K-step trainer at
               K = 1 over 7 steps against the eager fit (bit for bit, or
               within ``DYGRAPH_REL_GAP``) and K = 4 against K = 1 over 8
               steps (bit for bit); every batch each fit saw checksummed against the
               rows; the loader alone with each slot's copy delayed on the
               copy stream, once as built (no batch may differ) and once
               with a planted release of each slot before its copy's event
               (some batch must differ); ``start_d2h`` / ``finish_d2h`` on
               a bf16 and an int32 tensor; K1's launches by kernel (12 a step
               each), 0 plain calls; evaluate and predict on 2 batches (K1
               forward only); ``Model.save`` / ``Model.load`` into a model
               of other weights (equal weights, equal evaluate loss);
               ``summary``'s total against ``named_parameters``; ms/step
               from CUDA events (steps 3-7; K = 4: its second superstep)
               for the idiom, eager, K = 1 and K = 4; ``input_wait_seconds``
               p50 and max; the ``train_mfu`` / ``train_tokens_per_sec``
               gauges; peak memory; one profiled eager fit step.
ernie (the encoder: ERNIE-3.0-base-zh, 12 x 768, 12 heads, vocab 40,000,
               bf16 parameters, dropout 0, ``random_weights``): K1
               non-causal at its attention (b=64, s=512, H=12, D=64)
               against its plain version within ``FLASH_TOL`` (control and
               planted stale tile as in the flash phase), timed beside
               SDPA and its bound; 10 MLM steps of ``bench_ernie``'s
               recipe (``make_sharded_train_step``, Adam 1e-4, clip 1.0,
               the masked-positions batch of ``ernie_batch``, the custom
               ``ernie_loss_fn``) through K1, 12 launches a step per
               kernel and 0 plain calls, against 10 from the same weights
               through the plain composition (step 0 within
               ``ERNIE_REL_TOL`` relative); ms/step (CUDA events, steps
               3-10), tokens/s, peak memory and one profiled step (busy,
               idle, K1's share); at b=8 under a padding mask on half the
               rows the masked-positions rows against the full logits (bit
               for bit or within ``ERNIE_HEADS_TOL``), no K1 launch;
               ``ErnieForSequenceClassification`` through
               ``Model.fit(jit_compile=False)`` (5 steps, b=16, s=128: K1
               non-causal, 12 a step per kernel) and ``evaluate`` with
               ``metric.Accuracy`` (K1 forward only); ``Model.fit`` on
               ``Sequential(Linear, BatchNorm1D, Linear)`` falling back to
               the eager loop (``jit_compile=True`` naming the buffers),
               its running stats against the same fit on the CPU.

Then the kernel table line, the ``nvidia-smi`` line, and last the result
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the result line; without a CUDA device it exits 2.

``python3 chip_smoke.py --serving-ab N [--root DIR]`` runs only the
serving measurements, N times each: phase ``serving``'s paged bf16 run and
phase ``serving_int8``'s int8 run, on the same engines, prompts and
weights, each run a JSON line.  The package is imported from DIR (default:
this script's directory), so that two checkouts can be compared on one
card: run it once per tree in separate processes, alternating.

``python3 chip_smoke.py --tc16-ab N [--root DIR]`` likewise times K2's bf16
forward, dK/dV and dQ up to 256 at ``K2_TC16_SHAPES`` (D = 64, 128, 256)
and K1's three kernels at ``K1_AB_SHAPES`` (D = 64, 256), causal, s =
1024, N times each, from the package in DIR, after the ptxas report and
HGMMA counts of the five libraries it builds: to hold a change of
``csrc/flash_tc.cuh`` against its parent on one card, alternate the two
trees' processes (parent, change, change, parent).

``python3 chip_smoke.py --k3-ab N [--root DIR]`` likewise times K3 at
``k3_ab_cases`` (the f32 prefill chunks -- at the serving geometry, w128
over pages of 128, D = 256 and 512 --, decode at D = 512 in each type,
the bf16/f16 chunks up to 256 at w32 and w128, D = 64, 128 and 256, the
shapes whose kernel is unchanged, and the seven shapes the retired kernels
ran, ``K3_RETIRED_SHAPES``, each also beside SDPA on the gathered K/V
and its bound), after the paged library's ptxas report and HGMMA counts.

``python3 chip_smoke.py --ab-medians FILE`` reads the lines those modes
wrote to FILE and prints, in one JSON line, the median device time of each
shape per tree, SDPA's over all trees and the bounds: the figures an A/B
call reports.

``python3 chip_smoke.py --spec`` builds K3's and K4's libraries and runs
only the spec phase (its int8 artifact saved and loaded in the phase);
``--stages`` likewise runs only the stages phase; ``--deploy`` builds
K1's (D = 64), K3's and K4's libraries and runs only the deploy phase;
``--dygraph`` builds K1's library (D = 64) and runs only the dygraph
phase; ``--fit`` likewise runs only the fit phase, and ``--ernie`` the
ernie phase.  ``--fit-ab N`` runs
N alternating rounds of the idiom, the eager fit from the ring and from a
list of placed batches, and K = 1 and K = 4 from the ring (ms/step
medians and quartiles), then each loader alone.

``python3 chip_smoke.py --k4-ab N [--root DIR]`` likewise times K4, one
GPT-2-small layer's four int8 projections at M = 8 and 256, f32 and bf16
activations (``K4_AB_MS``), after the quant library's ptxas report.

``python3 chip_smoke.py --bwd-ab N [--root DIR]`` likewise times only K2's
f32 dK/dV and dQ kernels (graph replay), N times each, at ``BWD_AB_SHAPES``
(D = 64, 256, 264, 512, causal), from the package in DIR, with ptxas's
performance notes for the three f32 libraries where this process built
them.
"""

import json
import re
import subprocess
import sys
import threading
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12          # dense tensor-core bf16
H100_F32_FLOPS = 67e12            # f32 on the CUDA cores (no tensor cores)
H100_TF32_FLOPS = 494.7e12        # dense tensor-core tf32 (3xTF32: 3 each)
DEV = "cuda"


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def device_ms(torch, fns, reps=5):
    """Device time per call.  The calls are captured once into a CUDA graph
    that cycles over copies of the inputs which together exceed the 50 MB
    L2 (so each call reads its inputs from HBM, as on the serving path),
    and the graph is replayed between two CUDA events: no host work of the
    Python wrappers lands in the timed span."""
    for f in fns:              # lazy initialisation outside the capture
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for f in fns:
                f()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (reps * len(fns))


def copies(case, n=6):
    """``n`` copies of a kernel case in distinct memory (6 x ~25 MB of
    pools at the serving geometry: more than the L2 holds)."""
    return [case] + [{k: v.clone() for k, v in case.items()}
                     for _ in range(n - 1)]


def kernel_case(torch, dtype, width, seed, D=64, P=16, maxp=32):
    """Inputs at the serving geometry (or another head width, page size
    and table width): shuffled tables, slot 5 inactive (all-NULL table,
    stale length), lengths at 0, page boundaries and the last row of the
    table."""
    B, H = 16, 12
    N = 1 + B * maxp
    rng = np.random.RandomState(seed)
    pt = (rng.permutation(N - 1) + 1).reshape(B, maxp).astype(np.int32)
    T = maxp * P
    lengths = rng.randint(0, T - width + 1, B).astype(np.int32)
    lengths[:5] = np.minimum([0, P, P - 1, 2 * P - 1, T - width],
                             T - width)                   # T-width: last row
    pt[5] = 0
    lengths[5] = 300
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(*s).astype(np.float32)).to(DEV, dtype)
    return dict(q=mk(B, width, H, D), k_pool=mk(N, P, H, D),
                v_pool=mk(N, P, H, D),
                page_table=torch.from_numpy(pt).to(DEV),
                lengths=torch.from_numpy(lengths).to(DEV))


def serving_case(torch, width, seed, B=16):
    """Inputs as the serving run gives them: the engine's pool of 257 pages,
    16 slots (or ``B``) owning 14 shuffled pages each (the rest of each
    32-page table row NULL); decode widths (below 16: width 1, and the
    spec phase's verify width 9) at decode lengths 64..191, width 32 at the
    two prefill-chunk offsets 0 and 32."""
    H, D, P, maxp, N, own = 12, 64, 16, 32, 257, 14
    rng = np.random.RandomState(seed)
    pt = np.zeros((B, maxp), np.int32)
    pt[:, :own] = (rng.permutation(N - 1) + 1)[:B * own].reshape(B, own)
    if width < 16:
        lengths = rng.randint(64, 192, B).astype(np.int32)
    else:
        lengths = np.where(np.arange(B) % 2, 32, 0).astype(np.int32)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.randn(*s).astype(np.float32)).to(DEV, torch.bfloat16)
    return dict(q=mk(B, width, H, D), k_pool=mk(N, P, H, D),
                v_pool=mk(N, P, H, D),
                page_table=torch.from_numpy(pt).to(DEV),
                lengths=torch.from_numpy(lengths).to(DEV))


def bound(case, elem_bytes, flops_peak):
    """Least time for the function on these inputs: the larger of the bytes
    it must move (q, out, the table, the lengths, and each distinct live
    K/V row once) over the HBM rate, and its flops over the peak rate."""
    q, kp = case["q"], case["k_pool"]
    B, s, H, D = q.shape
    P = kp.shape[1]
    pt = case["page_table"].cpu().numpy()
    lens = case["lengths"].cpu().numpy().astype(np.int64)
    T = pt.shape[1] * P
    rows, keys = set(), 0
    for b in range(B):
        n = min(T, int(lens[b]) + s)
        t = np.arange(n)
        rows.update((pt[b, t // P] * P + t % P).tolist())
        keys += sum(min(T, int(lens[b]) + i + 1) for i in range(s))
    nbytes = (2 * q.numel() * elem_bytes + pt.size * 4 + B * 4
              + 2 * len(rows) * H * D * elem_bytes)
    flops = 4 * keys * H * D           # q.k and p.v, multiply + add
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / flops_peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def k3_bound(case):
    """``bound`` at the case's type: bf16/f16 products on the tensor
    cores, f32 as 3xTF32 (three tf32 products each)."""
    e = case["q"].element_size()
    return bound(case, e, H100_BF16_FLOPS if e == 2 else H100_TF32_FLOPS / 3)


def f32_case(case):
    """A paged case with q and the pools in f32."""
    return {k: v.float() if v.is_floating_point() else v
            for k, v in case.items()}


def gathered(torch, c):
    """A paged case's (q, K, V, mask) as SDPA takes them: the slots' pages
    gathered contiguous, (B, H, ., D), and the offset-causal mask (query i
    of slot b sees rows <= lengths[b] + i)."""
    B, s, H, D = c["q"].shape
    P = c["k_pool"].shape[1]
    rows = (c["page_table"].long()[:, :, None] * P
            + torch.arange(P, device=DEV)).reshape(B, -1)
    kb = c["k_pool"].reshape(-1, H, D)[rows].transpose(1, 2).contiguous()
    vb = c["v_pool"].reshape(-1, H, D)[rows].transpose(1, 2).contiguous()
    qh = c["q"].transpose(1, 2).contiguous()
    qpos = c["lengths"].long()[:, None] + torch.arange(s, device=DEV)
    mask = (torch.arange(rows.shape[1], device=DEV)[None, None]
            <= qpos[..., None])[:, None]
    return qh, kb, vb, mask


# the split decode kernel's cases: pages of 16, 128 and 512, each table
# 512-1024 rows long
SPLIT_PAGES = ((16, 32), (128, 4), (512, 2))


def many_slots_case(torch, dtype, width, seed, B=65538, H=2, D=64, P=16,
                    maxp=1):
    """B slots of ``maxp`` pages each (slot b on pages b maxp + 1 ...; page
    0 the NULL page), lengths up to the table's last row: past grid.y's
    65535."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=gen,  # noqa: E731
                                 device=DEV).to(dtype)
    N = B * maxp + 1
    lengths = torch.randint(0, maxp * P - width + 1, (B,), generator=gen,
                            device=DEV, dtype=torch.int32)
    return dict(q=mk(B, width, H, D), k_pool=mk(N, P, H, D),
                v_pool=mk(N, P, H, D),
                page_table=torch.arange(1, N, device=DEV,
                                        dtype=torch.int32).reshape(B, maxp),
                lengths=lengths)


# The shapes the retired kernels ran (the scalar paged_attention_kernel:
# f32 chunks past 256, over pages of 12 and with D % 4 != 0, decode rows
# not 16-byte aligned; the mma.sync copies: bf16 chunks over pages of 12,
# at D = 36 and at D = 260), timed in phase paged and by --k3-ab
K3_RETIRED_SHAPES = (
    ("f32_d320_w32", "float32", 32, 352, dict(D=320, maxp=8)),
    ("f32_p12_w32", "float32", 32, 43, dict(P=12, maxp=40)),
    ("f32_d38_w32", "float32", 32, 38, dict(D=38)),
    ("bf16_d36_w1", "bfloat16", 1, 37, dict(D=36)),
    ("bf16_p12_w32", "bfloat16", 32, 44, dict(P=12, maxp=40)),
    ("bf16_d36_w32", "bfloat16", 32, 68, dict(D=36)),
    ("bf16_d260_w32", "bfloat16", 32, 292, dict(D=260, maxp=8)))


def k3_retired_cases(torch):
    return {name: kernel_case(torch, getattr(torch, dt), w, seed=seed, **kw)
            for name, dt, w, seed, kw in K3_RETIRED_SHAPES}


# The planted fault of the TMA-vs-gathered check: K3's library built from
# a copy of its sources whose gathered producers write each 16-byte chunk
# of a row in place, without the 128-byte swizzle's XOR (gat::swz)
K3_UNSWIZZLED = ("paged_attention_unswizzled", "  return c ^ (r & 7);\n}",
                 "  return c;\n}")


def register_unswizzled(_build):
    """Write ``K3_UNSWIZZLED``'s patched copy of K3's sources under the
    gitignored build directory and register it with ``_build``, so that
    the run's one parallel build compiles it beside the others."""
    import shutil
    name, line, fault = K3_UNSWIZZLED
    src = _build.SOURCES["paged_attention"]
    d = _build.BUILD_DIR / "variants" / name
    d.mkdir(parents=True, exist_ok=True)
    for f in src.parent.glob("*.cuh"):
        shutil.copy(f, d / f.name)
    text = src.read_text()
    if text.count(line) != 1:
        raise AssertionError(f"{name}: gat::swz's XOR is not in "
                             f"{src.name} once")
    (d / src.name).write_text(text.replace(line, fault))
    _build.SOURCES[name] = d / src.name


def unswizzled_gather(pa, case):
    """The gathered chunk instance on ``case``, launched from the
    ``K3_UNSWIZZLED`` library through the wrapper (its library lookup
    pointed there for the one call)."""
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import _build
    load, bound = _build.load, dict(pa._fns)
    _build.load = lambda n: load(K3_UNSWIZZLED[0] if n == "paged_attention"
                                 else n)
    pa._fns.clear()
    try:
        return pa.chunk_instance(**case, gathered=True)
    finally:
        _build.load = load
        pa._fns.clear()
        pa._fns.update(bound)


def phase_kernel(torch, pa):
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = []

    def within_of(ref32, tol):
        return lambda got: bool(  # noqa: E731
            ((got.float() - ref32).abs() <= tol + tol * ref32.abs()).all())

    def check(name, case, tol):
        """The kernel against the plain version in f32, beside a control
        (the plain version in the inputs' dtype, which must pass) and a
        planted fault (the plain version with each slot's first page read
        from its second, which must fail); the call launches the kernel
        its route names (``tile_route``) and no other, and twice more
        gives the same bits."""
        before = dict(pa.kernel_launches)
        out = pa.paged_attention_kernel(**case)
        torch.cuda.synchronize()
        launched = {k: n - before[k] for k, n in pa.kernel_launches.items()}
        repeats = all(torch.equal(out, pa.paged_attention_kernel(**case))
                      for _ in range(2))
        f32 = f32_case(case)
        ref32 = pa.paged_attention_ref(**f32)
        bad = dict(f32, page_table=case["page_table"].clone())
        bad["page_table"][:, 0] = bad["page_table"][:, 1]
        within = within_of(ref32, tol)
        err = (out.float() - ref32).abs()
        # f16 cannot hold the plain version's -1e30 mask: its control is
        # the f32 result rounded to f16
        control = (pa.paged_attention_ref(**case)
                   if out.dtype != torch.float16 else ref32.half())
        B, s, _, D = case["q"].shape
        route = pa.tile_route(s, D, out.dtype, case["k_pool"].shape[1])
        ok = (within(out) and within(control)
              and not within(pa.paged_attention_ref(**bad)) and repeats
              and launched == {k: int(k == route) for k in launched})
        rec = {"case": name, "kernel": route, "launches": launched,
               "repeats_bitwise": repeats,
               "max_abs_err": float(err.max()), "tol": tol,
               "control_max_abs_err": float(
                   (control.float() - ref32).abs().max()), "ok": ok}
        checks.append(rec)
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"paged_attention kernel disagrees with "
                                 f"its plain version, or the limit does not "
                                 f"separate the control from the planted "
                                 f"fault: {rec}")
        return rec["max_abs_err"]

    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        tag = str(dtype).split('.')[-1]
        for width in (1, 32):
            check(f"{tag}_w{width}_maxlen",
                  kernel_case(torch, dtype, width, seed=width), tol)
        # the spec phase's verify tick: width spec_k + 1 = 9 on the split
        # decode kernel
        check(f"{tag}_w9_verify", kernel_case(torch, dtype, 9, seed=9), tol)
        # widths past one 16-row tile loop and one 64-row stage, pages
        # longer than a stage (read in parts), a head width that is not a
        # multiple of 8 (element loads)
        check(f"{tag}_w65", kernel_case(torch, dtype, 65, seed=65), tol)
        check(f"{tag}_w128_p128", kernel_case(torch, dtype, 128, seed=128,
                                              P=128, maxp=4), tol)
        check(f"{tag}_w256_p256", kernel_case(torch, dtype, 256, seed=256,
                                              P=256, maxp=2), tol)
        check(f"{tag}_w1_p128", kernel_case(torch, dtype, 1, seed=3, P=128,
                                            maxp=4), tol)
        check(f"{tag}_d36_w32", kernel_case(torch, dtype, 32, seed=36,
                                            D=36), tol)
        # past 256: decode steps the split kernel in column slices, f32
        # prefill the f32 kernel in 160-column chunks, bf16 prefill in
        # 256-column chunks, all on TMA boxes
        for D in (320, 512):
            for width in (1, 32):
                check(f"{tag}_d{D}_w{width}",
                      kernel_case(torch, dtype, width, seed=D + width, D=D,
                                  maxp=8), tol)
    # the bf16 prefill kernel past 256 where a box is part of a page (P =
    # 128: boxes of 64 rows) or pages are not a power of two (P = 48:
    # boxes of 16), and a row TMA cannot address (D = 260: the gathered
    # instance)
    for name, D, P, maxp in (("d512_w32_p128", 512, 128, 2),
                             ("d512_w32_p48", 512, 48, 3),
                             ("d260_w32", 260, 16, 8)):
        check(f"bfloat16_{name}", kernel_case(torch, torch.bfloat16, 32,
                                              seed=D + P, D=D, P=P,
                                              maxp=maxp), 2e-2)
    # the bf16/f16 prefill kernel up to 256 (paged TMA + wgmma): D = 64,
    # 128 and 256, one and two consumer warpgroups, widths of one q tile,
    # past it and of four, pages of 8, 16, 48 (boxes of 16) and 128 (boxes
    # of 64), D = 8 and 40 (a slice partly zero); the shapes TMA boxes
    # cannot take run the gathered instance, by route: pages of 12 (boxes
    # of 4 rows) and 5, D = 36 (8-byte rows) and 33 (2-byte rows)
    for dtype in (torch.bfloat16, torch.float16):
        tag = str(dtype).split('.')[-1]
        for name, w, kw in (("d64_w16_p8", 16, dict(P=8, maxp=64)),
                            ("d64_w32_p48", 32, dict(P=48, maxp=12)),
                            ("d64_w65", 65, {}),
                            ("d64_w200_p16", 200, dict(maxp=40)),
                            ("d128_w32", 32, dict(D=128)),
                            ("d128_w128_p128", 128, dict(D=128, P=128,
                                                         maxp=4)),
                            ("d128_w130_p8", 130, dict(D=128, P=8,
                                                       maxp=64)),
                            ("d256_w32", 32, dict(D=256)),
                            ("d256_w128_p128", 128, dict(D=256, P=128,
                                                         maxp=4)),
                            ("d8_w32", 32, dict(D=8)),
                            ("d40_w65_p16", 65, dict(D=40)),
                            ("d64_w32_p12", 32, dict(P=12, maxp=40)),
                            ("d36_w65", 65, dict(D=36)),
                            ("d33_w32", 32, dict(D=33)),
                            ("d128_w130_p12", 130, dict(D=128, P=12,
                                                        maxp=60)),
                            ("d64_w65_p5", 65, dict(P=5, maxp=100))):
            check(f"{tag}_{name}", kernel_case(torch, dtype, w,
                                               seed=w + 17, **kw), 2e-2)
    # the f32 prefill kernel (3xTF32 wgmma) at D = 128 and 256 (one
    # consumer warpgroup at 256), a chunk of two q tiles at 256, pages of
    # 48 (boxes of 16) and of 8, past 256 in 160-column chunks; pages of 12
    # and 6 (boxes of 4 and 2 rows) and D = 38 and 33 (8- and 4-byte rows)
    # on the gathered instance, by route
    for name, w, kw in (("d128_w32", 32, dict(D=128)),
                        ("d256_w32", 32, dict(D=256)),
                        ("d256_w128", 128, dict(D=256, maxp=16)),
                        ("p48_w32", 32, dict(P=48, maxp=12)),
                        ("p8_w65", 65, dict(P=8, maxp=64)),
                        ("d512_w128_p128", 128, dict(D=512, P=128, maxp=4)),
                        ("p12_w32", 32, dict(P=12, maxp=40)),
                        ("d320_w32_p12", 32, dict(D=320, P=12, maxp=20)),
                        ("d38_w32", 32, dict(D=38)),
                        ("p12_w130", 130, dict(P=12, maxp=60)),
                        ("d257_w65_p6", 65, dict(D=257, P=6, maxp=60)),
                        ("d33_w32", 32, dict(D=33))):
        check(f"float32_{name}", kernel_case(torch, torch.float32, w,
                                             seed=w + 11, **kw), 2e-5)
    # the split decode kernel's gathered instance (rows not a multiple of
    # 16 bytes): D = 36 in bf16/f16 at widths 1 and 15 over pages of 16 and
    # 12, D = 33 in bf16 and f32, past 256 D = 260 (bf16) and 257 (f32)
    for name, dtype, w, kw in (
            ("bf16_d36_w1", torch.bfloat16, 1, dict(D=36)),
            ("bf16_d36_w15", torch.bfloat16, 15, dict(D=36)),
            ("f16_d36_w1_p12", torch.float16, 1, dict(D=36, P=12, maxp=40)),
            ("f16_d36_w15_p12", torch.float16, 15, dict(D=36, P=12,
                                                        maxp=40)),
            ("bf16_d33_w1", torch.bfloat16, 1, dict(D=33)),
            ("f32_d33_w1", torch.float32, 1, dict(D=33)),
            ("bf16_d260_w1", torch.bfloat16, 1, dict(D=260, maxp=8)),
            ("f32_d257_w15", torch.float32, 15, dict(D=257, maxp=8))):
        check(f"split_g_{name}", kernel_case(torch, dtype, w, seed=w + 23,
                                             **kw),
              2e-5 if dtype == torch.float32 else 2e-2)
    # the TMA and gathered instances of each chunk kernel at a shape both
    # take: the same consumers and order, so the same bits; the planted
    # fault, the gathered instance of the K3_UNSWIZZLED library (its tiles
    # written without the swizzle's XOR), differs
    same = {}
    for dtype in (torch.bfloat16, torch.float32):
        case = kernel_case(torch, dtype, 32, seed=64)
        tma = pa.chunk_instance(**case, gathered=False)
        gat = pa.chunk_instance(**case, gathered=True)
        bad = unswizzled_gather(pa, case)
        torch.cuda.synchronize()
        tag = str(dtype).split('.')[-1]
        same[tag] = {"bitwise": torch.equal(tma, gat),
                     "fault_differs": not torch.equal(tma, bad),
                     "fault_max_abs": float((tma.float()
                                             - bad.float()).abs().max())}
        if not (same[tag]["bitwise"] and same[tag]["fault_differs"]):
            raise AssertionError(f"TMA and gathered instances: {same}")
        del case, tma, gat, bad
    checks.append({"case": "tma_vs_gathered_p16_d64_w32", "ok": True,
                   **same})
    # the Python mirror of the route and of the kernels' shared memory
    # against the library's own
    wrong = []
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for s in (1, 15, 16, 32, 65, 128):
            for D in (4, 8, 33, 36, 40, 64, 100, 128, 256, 257, 260, 264,
                      320, 512, 1032):
                for P in (1, 5, 6, 8, 12, 16, 48, 128):
                    got = pa.library_route(s, D, dtype, P)
                    if got != pa.tile_route(s, D, dtype, P):
                        wrong.append((str(dtype), s, D, P, got))
    for D in list(range(8, 257, 8)) + [264, 320, 512, 1024, 1032, 2048,
                                        8192]:
        for s in (16, 32, 65, 128):
            got = pa.library_tc_smem(D, s)
            if got != pa.tc_plan(1, s, 1, D, 16, torch.bfloat16)["smem"]:
                wrong.append(("tc_smem", D, s, got))
    for D in list(range(4, 257, 4)) + [260, 320, 384, 512, 1032, 2048]:
        for s in (16, 32, 65, 128):
            got = pa.library_tf32_smem(D, s)
            if got != pa.tf32_plan(1, s, 1, D, 16)["smem"]:
                wrong.append(("tf32_smem", D, s, got))
    for D in (33, 38, 257, 321):
        for s in (16, 65):
            got = pa.library_tf32_smem(D, s)
            plan = pa.gather_plan(1, s, 1, D, 16, torch.float32)
            if got != plan["smem"]:
                wrong.append(("tf32_g_smem", D, s, got))
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        for D in (33, 36, 64, 100, 128, 256, 260, 264, 320, 512, 520, 1024,
                  4096, 8192):
            for s in (1, 15):
                for P in (16, 48, 128, 512):
                    plan = pa.split_plan(12, D, dtype, P, 8, s)
                    got = pa.library_split_smem(dtype, s, D, plan.G, P)
                    if got != plan.smem:
                        wrong.append(("split_smem", str(dtype), D, s, P,
                                      got))
    checks.append({"case": "route_mirror", "ok": not wrong,
                   "mismatches": wrong})
    if wrong:
        raise AssertionError(f"K3's route or plan mirror disagrees with the "
                             f"library: {wrong}")
    # the split decode kernel: widths 1 and 15, pages of 16, 128 and 512,
    # D = 64, 128 and 256, in each dtype (bf16 and f16 rows of 128-512
    # bytes: groups of 4, 2 and 1 heads; f32 of 2, 1, 1)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float16, 2e-2),
                       (torch.float32, 2e-5)):
        tag = str(dtype).split('.')[-1]
        for P, maxp in SPLIT_PAGES:
            for D in (64, 128, 256):
                for width in (1, 15):
                    case = kernel_case(torch, dtype, width,
                                       seed=P + D + width, D=D, P=P,
                                       maxp=maxp)
                    check(f"split_{tag}_p{P}_d{D}_w{width}", case, tol)
                    del case
        # past 256: one head a group, its row in column slices (2-8 of
        # them, the last one part zeros at 264, 320 and 520)
        for D in (264, 320, 512, 1024):
            for width in (1, 15):
                for P, maxp in ((16, 8), (128, 2)) if D == 512 else \
                        ((16, 8),):
                    case = kernel_case(torch, dtype, width,
                                       seed=P + D + width, D=D, P=P,
                                       maxp=maxp)
                    check(f"split_{tag}_p{P}_d{D}_w{width}", case, tol)
                    del case
        torch.cuda.empty_cache()

    # slots past 65535 (grid.y's limit): the last two slots against the
    # plain version, the planted fault the plain version of the two
    # before, as a kernel that wrapped the slot index would read them
    # (and the gathered routes: two pages of 12 a slot at width 16, D = 36
    # at width 1)
    for dtype, width, tol, kw in (
            (torch.bfloat16, 1, 2e-2, {}), (torch.float32, 1, 2e-5, {}),
            (torch.bfloat16, 16, 2e-2, {}), (torch.float32, 16, 2e-5, {}),
            (torch.bfloat16, 16, 2e-2, dict(P=12, maxp=2)),
            (torch.float32, 16, 2e-5, dict(P=12, maxp=2)),
            (torch.bfloat16, 1, 2e-2, dict(D=36))):
        case = many_slots_case(torch, dtype, width, seed=width, **kw)
        out = pa.paged_attention_kernel(**case)
        B = case["q"].shape[0]
        part = lambda sl, c=case: dict(  # noqa: E731
            c, q=c["q"][sl].contiguous(),
            page_table=c["page_table"][sl].contiguous(),
            lengths=c["lengths"][sl].contiguous())
        tail, before = part(slice(B - 2, B)), part(slice(B - 3, B - 1))
        ref32 = pa.paged_attention_ref(**f32_case(tail))
        within = within_of(ref32, tol)
        got = out[B - 2:]
        ok = (within(got) and within(pa.paged_attention_ref(**tail))
              and not within(pa.paged_attention_ref(**f32_case(before))))
        tag = str(dtype).split('.')[-1] + "".join(
            f"_{k}{v}" for k, v in kw.items() if k != "maxp")
        checks.append({"case": f"b65538_{tag}_w{width}", "ok": ok,
                       "kernel": pa.tile_route(width, kw.get("D", 64),
                                               dtype, kw.get("P", 16)),
                       "max_abs_err": float((got.float() - ref32).abs().max()),
                       "tol": tol})
        if not ok:
            raise AssertionError(f"paged attention at 65538 slots: "
                                 f"{checks[-1]}")
        del case, out, tail, before
        torch.cuda.empty_cache()

    # the split kernel's summation order: three runs bit for bit, and each
    # slot alone the same bits as among 16 (slots of one chunk and of
    # several); the planted fault, each slot alone against its neighbour
    # among 16, must differ
    invariance = {}
    for name, case in (("serving", serving_case(torch, 1, seed=7)),
                       ("maxlen", kernel_case(torch, torch.bfloat16, 1,
                                              seed=8)),
                       ("f32_p128_w15", kernel_case(torch, torch.float32, 15,
                                                    seed=9, P=128, maxp=4)),
                       ("d512", kernel_case(torch, torch.bfloat16, 1, seed=10,
                                            D=512, maxp=8)),
                       ("f32_d320_w15", kernel_case(torch, torch.float32, 15,
                                                    seed=11, D=320,
                                                    maxp=8)),
                       ("gathered_d36", kernel_case(torch, torch.bfloat16, 1,
                                                    seed=12, D=36)),
                       ("gathered_d36_w15_p12", kernel_case(
                           torch, torch.float16, 15, seed=13, D=36, P=12,
                           maxp=40))):
        out = pa.paged_attention_kernel(**case)
        repeats = all(torch.equal(out, pa.paged_attention_kernel(**case))
                      for _ in range(2))
        B = out.shape[0]
        alone = [pa.paged_attention_kernel(**dict(
            case, q=case["q"][b:b + 1].contiguous(),
            page_table=case["page_table"][b:b + 1].contiguous(),
            lengths=case["lengths"][b:b + 1].contiguous()))[0]
            for b in range(B)]
        same = all(torch.equal(alone[b], out[b]) for b in range(B))
        fault = any(torch.equal(alone[b], out[(b + 1) % B])
                    for b in range(B))
        invariance[name] = {"repeats_bitwise": repeats,
                            "alone_vs_batched_bitwise": same,
                            "fault_neighbour_equal": fault}
        if not (repeats and same and not fault):
            raise AssertionError(f"the split decode kernel is not bit for "
                                 f"bit the same over repeats and batches: "
                                 f"{name} {invariance[name]}")
        del case, out, alone
    torch.cuda.empty_cache()

    lib = lambda a: F.scaled_dot_product_attention(  # noqa: E731
        a[0], a[1], a[2], attn_mask=a[3])

    def times(case, plain_reps=5):
        """The kernel, the plain version and SDPA on the gathered K/V, over
        input copies larger than the L2, beside the bound (f16: the plain
        version on the inputs in f32, since f16 cannot hold its -1e30
        mask)."""
        cs = copies(case)
        half = case["q"].dtype == torch.float16
        row = {"ms": device_ms(torch, [
                   lambda c=c: pa.paged_attention_kernel(**c) for c in cs]),
               "plain_ms": device_ms(torch, [
                   lambda c=c: pa.paged_attention_ref(
                       **(f32_case(c) if half else c)) for c in cs],
                   reps=plain_reps)}
        if half:
            row["plain_on"] = "float32"
        libs = [gathered(torch, c) for c in cs]
        row["library_ms"] = device_ms(torch, [lambda a=a: lib(a)
                                              for a in libs])
        row["library_vs_kernel_max_abs"] = float(
            (lib(libs[0]).transpose(1, 2).float()
             - pa.paged_attention_kernel(**case).float()).abs().max())
        row["bound_ms"], row["bound_by"] = k3_bound(case)
        del cs, libs
        torch.cuda.empty_cache()
        return row

    case = serving_case(torch, 1, seed=1)
    err = check("bfloat16_w1_serving", case, 2e-2)
    wide = serving_case(torch, 32, seed=32)
    err_w32 = check("bfloat16_w32_serving", wide, 2e-2)
    decode = times(case)
    chunk = times(wide)
    maxlen = times(kernel_case(torch, torch.bfloat16, 1, seed=1))
    # the f16 serving chunk (the same kernel in f16)
    f16w = {k: v.half() if v.is_floating_point() else v
            for k, v in wide.items()}
    f16_w32 = dict(times(f16w), max_abs_err=check("float16_w32_serving",
                                                  f16w, 2e-2))
    # a 128-row prefill chunk over pages of 128 (the wide paged engine's),
    # beside SDPA with the offset-causal mask over the gathered K/V
    w128 = times(kernel_case(torch, torch.bfloat16, 128, seed=129, P=128,
                             maxp=4), plain_reps=2)
    # the chunk at D = 128 and 256: 32 rows over pages of 16, 128 over
    # pages of 128
    wider = {f"d{D}_w{w}": times(kernel_case(torch, torch.bfloat16, w,
                                             seed=D + w, D=D, **kw),
                                 plain_reps=2)
             for D in (128, 256)
             for w, kw in ((32, {}), (128, dict(P=128, maxp=4)))}
    # the shapes the retired kernels ran (the scalar kernel and the
    # mma.sync copies), each on its route now, checked and timed beside its
    # bound and SDPA
    retired = {}
    for name, c in k3_retired_cases(torch).items():
        e = check(f"retired_{name}", c, 2e-5 if "f32" in name else 2e-2)
        retired[name] = dict(times(c, plain_reps=2), max_abs_err=e,
                             kernel=checks[-1]["kernel"])
        del c
    # the f32 prefill kernel at the f32 serving cross-check's chunk (the
    # serving run's pool and tables in f32) and at the f32 paged_wide
    # engine's chunk of 128 over pages of 128; SDPA in f32, TF32 off
    f32w = f32_case(serving_case(torch, 32, seed=32))
    err_f32 = check("float32_w32_serving", f32w, 2e-5)
    f32_w32 = dict(times(f32w), max_abs_err=err_f32)
    f32_w128 = times(kernel_case(torch, torch.float32, 128, seed=129,
                                 P=128, maxp=4), plain_reps=2)
    f32_w128["max_abs_err"] = next(c["max_abs_err"] for c in checks
                                   if c["case"] == "float32_w128_p128")
    # the verify tick of the spec phase's paged engine: 8 slots, width 9 at
    # decode lengths, bf16 and f32
    verify = {}
    for tag, c in (("bf16", serving_case(torch, 9, seed=90, B=8)),
                   ("f32", f32_case(serving_case(torch, 9, seed=91, B=8)))):
        e = check(f"{tag}_w9_verify_serving", c,
                  2e-5 if tag == "f32" else 2e-2)
        verify[tag] = dict(times(c), max_abs_err=e,
                           kernel=checks[-1]["kernel"])
        del c
    emit({"phase": "paged", "checks": checks, "invariance": invariance,
          "decode_w1_serving": decode, "chunk_w32_serving": chunk,
          "decode_w1_maxlen": maxlen, "chunk_w128_p128": w128,
          "chunk_wider": wider, "retired_shapes": retired,
          "f16_chunk_w32_serving": f16_w32,
          "f32_chunk_w32_serving": f32_w32, "f32_chunk_w128_p128": f32_w128,
          "verify_w9_serving": verify})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    err_of = {c["case"]: c["max_abs_err"] for c in checks
              if "max_abs_err" in c}
    tc = {"w32": dict(chunk, max_abs_err=err_w32), "f16_w32": f16_w32,
          "w128": dict(w128, max_abs_err=err_of["bfloat16_w128_p128"]),
          "d128_w32": dict(wider["d128_w32"],
                           max_abs_err=err_of["bfloat16_d128_w32"]),
          "d128_w128": dict(wider["d128_w128"],
                            max_abs_err=err_of["bfloat16_d128_w128_p128"]),
          "d256_w32": dict(wider["d256_w32"],
                           max_abs_err=err_of["bfloat16_d256_w32"]),
          "d256_w128": dict(wider["d256_w128"],
                            max_abs_err=err_of["bfloat16_d256_w128_p128"])}
    return ({"max_abs_err": err, **{k: decode[k] for k in keys},
             "maxlen": {k: maxlen[k] for k in keys}},
            {name: {k: row[k] for k in keys + ("max_abs_err",)}
             for name, row in tc.items()},
            {name: {k: row[k] for k in keys + ("max_abs_err",)}
             for name, row in (("w32", f32_w32), ("w128", f32_w128))},
            {name: {k: row[k] for k in keys + ("kernel", "max_abs_err")}
             for name, row in retired.items()},
            {name: {k: row[k] for k in keys + ("kernel", "max_abs_err")}
             for name, row in verify.items()})


# ---------------------------------------------------------------------------
# K1: the packed flash-attention kernels
# ---------------------------------------------------------------------------

# K1 limits.  Each slice of the result (O, dQ, dK, dV) is held against the
# plain version run in f32 on the same inputs by two readings: "rel",
# ||err|| / ||ref|| over the slice, and "row", the worst (batch, row, head)
# D-vector's ||err|| / ||ref||, with the slice's median row norm as the floor
# of the denominator (a causal dQ row 0 is zero).  The LSE is held by its
# largest absolute error.  Beside the kernel, every case reads a control
# (the plain version in the kernel's own dtype, put in its place: bf16
# rounding alone) and a planted fault (the same, with kv tile 1 read as a
# stale copy of tile 0), which must pass and fail the limits.
FLASH_TOL = {"rel": 1e-2, "row": 0.2, "lse": 2e-3}
FLASH_SLICES = ("out", "dq", "dk", "dv")
TRAIN_SHAPE = dict(b=32, s=1024, H=12, D=64)    # bench.py's gpt2 row
FLASH_VS_PLAIN_RTOL = 1e-3


def flash_case(torch, b, s, H, D, dtype, seed):
    """A random packed qkv (b, s, 3*H*D) and an output cotangent."""
    rng = np.random.RandomState(seed)
    qkv = torch.from_numpy((rng.randn(b, s, 3 * H * D) * 0.5).astype(
        np.float32)).to(DEV, dtype)
    cot = torch.from_numpy(rng.randn(b, s, H * D).astype(np.float32)).to(
        DEV, dtype)
    return qkv, cot


def flash_slices(out, lse, dqkv, H):
    """O, LSE, dQ, dK and dV in f32, each row a D-vector."""
    b, s, hd = out.shape
    g = dqkv.float().reshape(b, s, 3, H, hd // H)
    return {"out": out.float().reshape(b, s, H, hd // H),
            "lse": lse.float(), "dq": g[:, :, 0], "dk": g[:, :, 1],
            "dv": g[:, :, 2]}


def flash_readings(got, ref, live_floor=False):
    """Each slice's error readings (see ``FLASH_TOL``).  ``live_floor``
    takes the row floor as the median over the rows whose reference is
    not zero (with sq < skv, causal, most kv rows get no gradient)."""
    r = {"lse": float((got["lse"] - ref["lse"]).abs().max())}
    for k in FLASH_SLICES:
        err = got[k] - ref[k]
        row_ref = ref[k].norm(dim=-1)
        floor = (row_ref[row_ref > 0] if live_floor else row_ref).median()
        r[k] = {"rel": float(err.norm() / ref[k].norm()),
                "row": float((err.norm(dim=-1)
                              / row_ref.clamp_min(floor)).max()),
                "max_abs": float(err.abs().max())}
    return r


def flash_within(r, tol=FLASH_TOL):
    return r["lse"] <= tol["lse"] and all(
        r[k]["rel"] <= tol["rel"] and r[k]["row"] <= tol["row"]
        for k in FLASH_SLICES)


def chunk_spans(D, cc):
    """(start, width) of each output chunk of ``cc`` columns past the
    first: chunk c holds columns c cc .. c cc + width - 1 of D."""
    return [(c * cc, min(cc, D - c * cc)) for c in range(1, -(-D // cc))]


def repeat_chunks(v, D, cc):
    """``v`` (..., D) with each later chunk's columns a copy of the first
    chunk's leading columns."""
    v = v.clone()
    for c0, w in chunk_spans(D, cc):
        v[..., c0:c0 + w] = v[..., :w]
    return v


def chunks_equal(o, D, cc):
    """Whether each later chunk of ``o`` (..., D) equals the first chunk's
    leading columns bit for bit: with V's chunks repeated, the blocks of
    one row's chunks took the same scores, max and sum (the LSE chunk 0
    writes is every chunk's)."""
    import torch
    return all(torch.equal(o[..., c0:c0 + w], o[..., :w])
               for c0, w in chunk_spans(D, cc))


def flash_plain(fap, qkv, cot, H, causal, scale, p=0.0, seed=None):
    """The plain forward and backward on ``qkv`` in its own dtype."""
    out, lse = fap.flash_packed_fwd_ref(qkv, H, causal, scale, p, seed)
    grad = fap.flash_packed_bwd_ref(qkv, out, lse, cot, H, causal, scale, p,
                                    seed)
    return flash_slices(out, lse, grad, H)


def strided_view(torch, t):
    """Batch-1 ``t`` as a view whose batch stride is not ``s * width`` (a
    slice of a larger buffer, 128 bytes in): PyTorch calls it contiguous,
    since the batch has size 1, so the kernels take it as it is."""
    _, s, w = t.shape
    buf = torch.zeros(s * w + 128, dtype=t.dtype, device=t.device)
    view = buf.as_strided((1, s, w), (s * w + 64, w, 1), storage_offset=64)
    view.copy_(t)
    return view


def stale_tile(qkv, H, tile=64):
    """The planted fault's input: k and v of kv tile 1 replaced by tile 0's,
    as a kernel that kept reading a stale double-buffered tile sees them."""
    bad = qkv.clone()
    hd = qkv.shape[-1] // 3
    n = min(tile, qkv.shape[1] - tile)        # a short last tile (s < 128)
    bad[:, tile:tile + n, hd:] = qkv[:, :n, hd:]
    return bad


def flash_bound(b, s, H, D, causal, products, nbytes, peak=H100_BF16_FLOPS):
    """Least time for one kernel: ``products`` (s x s x D) matrix products
    over the score pairs this input needs (the causal half with the
    diagonal, or all) at the ``peak`` rate of their type, against the
    bytes it must move."""
    pairs = s * (s + 1) // 2 if causal else s * s
    flops = 2 * products * D * pairs * b * H
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def profiled_ms(torch, fn, reps=5):
    """Device time per call: the kernels' own time under
    ``torch.profiler`` over ``reps`` eager calls (for a library call that
    a graph capture does not take; host gaps between its kernels are not
    counted)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(device_us(e) for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return us / 1e3 / reps


def device_us(e):
    """An event's own device time in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(e, attr, None)
        if v:
            return float(v)
    return 0.0


def phase_flash(torch, fap, fa):
    import math

    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = []

    def check(name, b, s, H, D, causal, dtype=torch.bfloat16, p=0.0,
              seed=None, strided=False):
        qkv, cot = flash_case(torch, b, s, H, D, dtype, seed=len(checks))
        if strided:
            qkv = strided_view(torch, qkv)
        scale = 1.0 / math.sqrt(D)
        out, lse = fap.flash_packed_fwd_kernel(qkv, H, causal, scale, p,
                                               seed)
        x = (strided_view(torch, qkv) if strided else qkv.clone()).detach()
        x.requires_grad_(True)
        fap.flash_attention_packed(x, H, causal, scale, p, seed).backward(cot)
        # the backward kernels again, twice: bit-identical to each other and
        # to the gradient through autograd
        args = (H, causal, scale, p, seed)
        again = [fap.flash_packed_bwd_kernel(qkv, out, lse, cot, *args)
                 for _ in range(2)]
        torch.cuda.synchronize()
        bitwise = (torch.equal(again[0], again[1])
                   and torch.equal(again[0], x.grad))
        extra = {}
        if D > 256:
            # the tensor-core forward past 256: twice more, bit for bit, and
            # on a qkv whose V chunks repeat, every chunk of O the first's
            cc = fap.fwd_plan(b, s, H, D, dtype)["chunk_cols"]
            reps = [fap.flash_packed_fwd_kernel(qkv, H, causal, scale, p,
                                                seed) for _ in range(2)]
            x5 = qkv.reshape(b, s, 3, H, D).clone()
            x5[:, :, 2] = repeat_chunks(x5[:, :, 2], D, cc)
            o_rep = fap.flash_packed_fwd_kernel(
                x5.reshape(qkv.shape), H, causal, scale, p, seed)[0]
            torch.cuda.synchronize()
            extra = {"fwd_bitwise_repeat": all(
                         torch.equal(u, w) for rep in reps
                         for u, w in zip(rep, (out, lse))),
                     "chunks_share_row_stats": chunks_equal(
                         o_rep.reshape(b, s, H, D), D, cc)}
            del reps, x5, o_rep
        ref = flash_plain(fap, qkv.float(), cot.float(), *args)
        got = {"kernel": flash_slices(out, lse, x.grad, H),
               "control": flash_plain(fap, qkv, cot, *args),
               "fault": flash_plain(fap, stale_tile(qkv, H), cot, *args)}
        r = {k: flash_readings(v, ref) for k, v in got.items()}
        ok = (flash_within(r["kernel"]) and flash_within(r["control"])
              and not flash_within(r["fault"]) and bitwise
              and all(extra.values()))
        # [LSE, then (rel, row) for O, dQ, dK, dV]: a short line
        checks.append({"case": name, "ok": ok, "bitwise_repeat": bitwise,
                       **extra, "bwd_kernel": fap.bwd_kernel_of(D),
                       "scale_path": ("fold" if fap.scale_folds(dtype, scale)
                                      else "in_tile"), **{
            k: [v["lse"]] + [v[s][m] for s in FLASH_SLICES
                             for m in ("rel", "row")]
            for k, v in r.items()}})

    check("causal_b2_s256_h4", 2, 256, 4, 64, True)
    check("noncausal_b2_s256_h4", 2, 256, 4, 64, False)
    check("causal_dropout0.1", 2, 256, 4, 64, True, p=0.1, seed=1234)
    check("noncausal_dropout0.1", 1, 192, 2, 64, False, p=0.1, seed=-7)
    check("train_geometry_b4_s1024_h12", 4, 1024, 12, 64, True)
    check("ragged_s1000_h2", 2, 1000, 2, 64, True)
    check("ragged_s1000_h2_noncausal", 1, 1000, 2, 64, False)
    check("f16_causal", 2, 512, 4, 64, True, dtype=torch.float16)
    check("d32_h4", 2, 256, 4, 32, True)
    check("d128_h2", 2, 256, 2, 128, True)
    # widths whose padding columns the tensor maps zero-fill, a lone row in
    # the last tile, and batch 1 on a strided view
    check("d40_h4", 2, 256, 4, 40, True)
    check("d80_h2_noncausal", 2, 256, 2, 80, False)
    check("s65_h2", 2, 65, 2, 64, True)
    check("b1_strided_view_h4", 1, 256, 4, 64, True, strided=True)
    # the widest instances: D = 256 (bf16 folds the scale, f16 scales its
    # tiles; the backward's 64-row blocks split the output columns) and
    # D = 192 (columns 192..255 zero-filled by the tensor maps)
    check("d256_h2", 2, 256, 2, 256, True)
    check("d256_h2_f16_noncausal", 2, 256, 2, 256, False,
          dtype=torch.float16)
    check("d256_dropout0.1", 2, 256, 2, 256, True, p=0.1, seed=99)
    check("d192_h2", 2, 256, 2, 192, True)
    check("d192_h2_ragged_s200", 1, 200, 2, 192, True)
    # past 256: the tensor-core forward (256-column chunks: D = 320 in two,
    # the second 64 columns; 384; 512 in two; 1024 in four, q resident at
    # its limit) and the column-chunked backward, bf16 and f16, at (s, H)
    # the JAX plan admits
    check("d320_h2", 2, 256, 2, 320, True)
    check("d384_h2", 2, 256, 2, 384, True)
    check("d512_h1", 2, 256, 1, 512, True)
    check("d512_h2_noncausal_dropout0.1", 1, 256, 2, 512, False, p=0.1,
          seed=5)
    check("d1024_h2", 1, 256, 2, 1024, True)
    check("d320_h2_f16", 2, 256, 2, 320, True, dtype=torch.float16)
    check("d384_h1_f16_dropout0.1", 2, 256, 1, 384, True,
          dtype=torch.float16, p=0.1, seed=11)
    check("d512_h2_f16", 1, 256, 2, 512, True, dtype=torch.float16)
    check("d1024_h1_f16_noncausal", 1, 256, 1, 1024, False,
          dtype=torch.float16)

    def check_many_heads(name, D, b=32769, s=8, H=2):
        # b * H past 65535, grid.y's limit: the last two batches' heads (bh
        # 65534..65537) against the plain version; the planted fault is the
        # plain version of the batches before, as a kernel that wrapped bh
        # would read them
        gen = torch.Generator(device=DEV).manual_seed(len(checks))
        qkv = (torch.randn(b, s, 3 * H * D, generator=gen, device=DEV)
               * 0.5).to(torch.bfloat16)
        cot = torch.randn(b, s, H * D, generator=gen, device=DEV).to(
            torch.bfloat16)
        scale = 1.0 / math.sqrt(D)
        out, lse = fap.flash_packed_fwd_kernel(qkv, H, True, scale)
        dqkv = fap.flash_packed_bwd_kernel(qkv, out, lse, cot, H, True, scale)
        tail, before = slice(b - 2, b), slice(b - 3, b - 1)
        ref = flash_plain(fap, qkv[tail].float(), cot[tail].float(), H, True,
                          scale)
        got = {"kernel": flash_slices(out[tail], lse[tail], dqkv[tail], H),
               "control": flash_plain(fap, qkv[tail], cot[tail], H, True,
                                      scale),
               "fault": flash_plain(fap, qkv[before], cot[tail], H, True,
                                    scale)}
        r = {k: flash_readings(v, ref) for k, v in got.items()}
        ok = (flash_within(r["kernel"]) and flash_within(r["control"])
              and not flash_within(r["fault"]))
        checks.append({"case": name, "ok": ok, **{
            k: [v["lse"]] + [v[s][m] for s in FLASH_SLICES
                             for m in ("rel", "row")]
            for k, v in r.items()}})
        del qkv, cot, out, lse, dqkv

    check_many_heads("bh65538_d64", 64)      # the TMA / wgmma instance
    check_many_heads("bh65538_d320", 320)    # the column-chunked kernels
    emit({"phase": "flash_checks", "tolerances": FLASH_TOL,
          "fields": ["lse"] + [f"{s}_{m}" for s in FLASH_SLICES
                               for m in ("rel", "row")],
          "checks": checks})
    bad = [c["case"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions, or the limits do not separate the "
                             f"control from the planted fault: {bad}")

    # timing at the train step's shape
    b, s, H, D = (TRAIN_SHAPE[k] for k in "bsHD")
    scale = 1.0 / math.sqrt(D)
    qkv, dout = flash_case(torch, b, s, H, D, torch.bfloat16, seed=100)
    out, lse = fap.flash_packed_fwd_kernel(qkv, H, True, scale)
    delta = fap._delta(out, dout, H)
    dqkv = torch.empty_like(qkv)
    ms = {
        "fwd": device_ms(torch, [
            lambda: fap.flash_packed_fwd_kernel(qkv, H, True, scale)]),
        "dkdv": device_ms(torch, [lambda: fap.flash_packed_dkdv_kernel(
            qkv, dout, lse, delta, dqkv, H, True, scale)]),
        "dq": device_ms(torch, [lambda: fap.flash_packed_dq_kernel(
            qkv, dout, lse, delta, dqkv, H, True, scale)]),
    }
    plain_fwd = device_ms(torch, [
        lambda: fap.flash_packed_fwd_ref(qkv, H, True, scale)], reps=2)
    plain_bwd = device_ms(torch, [lambda: fap.flash_packed_bwd_ref(
        qkv, out, lse, dout, H, True, scale)], reps=2)
    # the timed kernels' results at this shape against the plain version in
    # f32, and the plain version in bf16 as the control
    ref = flash_plain(fap, qkv.float(), dout.float(), H, True, scale)
    train = {"kernel": flash_readings(flash_slices(out, lse, dqkv, H), ref),
             "control": flash_readings(flash_plain(fap, qkv, dout, H, True,
                                                   scale), ref)}
    del ref
    torch.cuda.empty_cache()
    if not flash_within(train["kernel"]):
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at {TRAIN_SHAPE}: {train}")
    # the library yardstick on pre-split (b, H, s, D) tensors
    qh, kh, vh = (t.reshape(b, s, H, D).transpose(1, 2).contiguous()
                  .requires_grad_(True) for t in qkv.split(H * D, -1))
    doh = dout.reshape(b, s, H, D).transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = device_ms(torch, [lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)])
        lib_out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_vs_kernel = float((lib_out.transpose(1, 2).reshape(b, s, H * D)
                           .float() - out.float()).abs().max())
    og = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
        og, (qh, kh, vh), doh, retain_graph=True))
    del og, qh, kh, vh, doh, lib_out
    # determinism at this shape: the pair once more into a fresh dqkv
    dqkv2 = torch.empty_like(qkv)
    fap.flash_packed_dkdv_kernel(qkv, dout, lse, delta, dqkv2, H, True,
                                 scale)
    fap.flash_packed_dq_kernel(qkv, dout, lse, delta, dqkv2, H, True, scale)
    torch.cuda.synchronize()
    bitwise = torch.equal(dqkv, dqkv2)
    del dqkv2
    if not bitwise:
        raise AssertionError("the backward kernels gave two different "
                             "dqkv on one input")

    e = 2  # bytes per bf16 element
    io = qkv.numel() * e + lse.numel() * 4
    bwd_in = io + dout.numel() * e + delta.numel() * 4
    bounds = {
        "fwd": flash_bound(b, s, H, D, True, 2, io + out.numel() * e),
        "dkdv": flash_bound(b, s, H, D, True, 4,
                            bwd_in + 2 * b * s * H * D * e),
        "dq": flash_bound(b, s, H, D, True, 3, bwd_in + b * s * H * D * e),
    }
    plain = {"fwd": plain_fwd, "dkdv": plain_bwd, "dq": plain_bwd}
    lib = {"fwd": lib_fwd, "dkdv": lib_bwd, "dq": lib_bwd}
    got = train["kernel"]
    errs = {"fwd": got["out"]["max_abs"],
            "dkdv": max(got["dk"]["max_abs"], got["dv"]["max_abs"]),
            "dq": got["dq"]["max_abs"]}
    rows, timing = {}, {}
    for k in ("fwd", "dkdv", "dq"):
        b_ms, b_by, flops, nbytes = bounds[k]
        rows[k] = {"max_abs_err": errs[k], "ms": ms[k],
                   "plain_ms": plain[k], "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib[k]}
        timing[k] = dict(rows[k], gflop=flops / 1e9, gbytes=nbytes / 1e9,
                         tflops=flops / ms[k] / 1e9)
    pair = ms["dkdv"] + ms["dq"]
    wide = flash_wide_times(torch, fap, F)
    emit({"phase": "flash", "shape": TRAIN_SHAPE, "causal": True,
          "readings": train,
          "library_vs_kernel_out_max_abs": lib_vs_kernel,
          "plain_note": "dkdv and dq share one plain backward and one "
                        "library backward (each computes dq, dk, dv)",
          "timing": timing,
          "backward_pair": {
              "ms": pair, "bound_ms": bounds["dkdv"][0] + bounds["dq"][0],
              "sdpa_bf16_backward_ms": lib_bwd,
              "over_sdpa": pair / lib_bwd, "bitwise_repeat": bitwise},
          "fwd_over_sdpa": ms["fwd"] / lib_fwd,
          "wide": wide})
    for k in rows:
        rows[k]["wide_d256"] = {key: wide["timing"][k][key] for key in
                                ("ms", "bound_ms", "bound_by", "library_ms")}
    return rows


WIDE_SHAPE = dict(b=8, s=1024, H=4, D=256)   # the wide GPT's attention


def flash_wide_times(torch, fap, F):
    """K1's three kernels at ``WIDE_SHAPE`` (D = 256, causal)."""
    return k1_times(torch, fap, F, WIDE_SHAPE, True, seed=101)


def k1_times(torch, fap, F, shape, causal, seed, control=False):
    """K1's three kernels at ``shape`` (bf16) by graph replay, beside
    their bounds, the plain versions and the library's bf16 SDPA forward
    and backward on pre-split heads; the timed results held against the
    plain version in f32 within ``FLASH_TOL``.  ``control`` also holds the
    plain version in bf16 to the limits and a planted stale tile outside
    them, as the flash phase's checks do."""
    import math
    b, s, H, D = (shape[k] for k in "bsHD")
    scale = 1.0 / math.sqrt(D)
    qkv, dout = flash_case(torch, b, s, H, D, torch.bfloat16, seed=seed)
    out, lse = fap.flash_packed_fwd_kernel(qkv, H, causal, scale)
    delta = fap._delta(out, dout, H)
    dqkv = torch.empty_like(qkv)
    ms = {
        "fwd": device_ms(torch, [
            lambda: fap.flash_packed_fwd_kernel(qkv, H, causal, scale)]),
        "dkdv": device_ms(torch, [lambda: fap.flash_packed_dkdv_kernel(
            qkv, dout, lse, delta, dqkv, H, causal, scale)]),
        "dq": device_ms(torch, [lambda: fap.flash_packed_dq_kernel(
            qkv, dout, lse, delta, dqkv, H, causal, scale)]),
    }
    plain_fwd = device_ms(torch, [
        lambda: fap.flash_packed_fwd_ref(qkv, H, causal, scale)], reps=2)
    plain_bwd = device_ms(torch, [lambda: fap.flash_packed_bwd_ref(
        qkv, out, lse, dout, H, causal, scale)], reps=2)
    ref = flash_plain(fap, qkv.float(), dout.float(), H, causal, scale)
    readings = flash_readings(flash_slices(out, lse, dqkv, H), ref)
    checks = {}
    if control:
        checks = {"control": flash_readings(flash_plain(
                      fap, qkv, dout, H, causal, scale), ref),
                  "fault": flash_readings(flash_plain(
                      fap, stale_tile(qkv, H), dout, H, causal, scale), ref)}
    del ref
    torch.cuda.empty_cache()
    if not flash_within(readings) or (control and (
            not flash_within(checks["control"])
            or flash_within(checks["fault"]))):
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at {shape}, or the limits do not "
                             f"separate the control from the planted "
                             f"fault: {readings} {checks}")
    qh, kh, vh = (t.reshape(b, s, H, D).transpose(1, 2).contiguous()
                  .requires_grad_(True) for t in qkv.split(H * D, -1))
    doh = dout.reshape(b, s, H, D).transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = device_ms(torch, [lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal)])
    og = F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)
    lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
        og, (qh, kh, vh), doh, retain_graph=True))
    del og, qh, kh, vh, doh
    e = 2
    io = qkv.numel() * e + lse.numel() * 4
    bwd_in = io + dout.numel() * e + delta.numel() * 4
    bounds = {
        "fwd": flash_bound(b, s, H, D, causal, 2, io + out.numel() * e),
        "dkdv": flash_bound(b, s, H, D, causal, 4,
                            bwd_in + 2 * b * s * H * D * e),
        "dq": flash_bound(b, s, H, D, causal, 3,
                          bwd_in + b * s * H * D * e),
    }
    plain = {"fwd": plain_fwd, "dkdv": plain_bwd, "dq": plain_bwd}
    lib = {"fwd": lib_fwd, "dkdv": lib_bwd, "dq": lib_bwd}
    errs = {"fwd": readings["out"]["max_abs"],
            "dkdv": max(readings["dk"]["max_abs"],
                        readings["dv"]["max_abs"]),
            "dq": readings["dq"]["max_abs"]}
    timing = {}
    for k in ("fwd", "dkdv", "dq"):
        b_ms, b_by, flops, nbytes = bounds[k]
        timing[k] = {"max_abs_err": errs[k], "ms": ms[k],
                     "plain_ms": plain[k], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib[k],
                     "gflop": flops / 1e9, "gbytes": nbytes / 1e9,
                     "tflops": flops / ms[k] / 1e9}
    del qkv, dout, out, lse, delta, dqkv
    torch.cuda.empty_cache()
    return {"shape": shape, "causal": causal, "readings": readings,
            **checks, "timing": timing}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def profile_summary(torch, prof, wall):
    """Device busy time and idle share over ``wall``, the count of kernel
    launches (and of copies and sets apart), and the top device kernels
    and host ops, from a ``torch.profiler`` run."""
    # device-side events only (kernels, copies): a CPU op's self device
    # time repeats the time of the kernels it launched
    events = prof.key_averages()
    rows = [(e.key, device_us(e), e.count) for e in events
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = [r for r in rows if r[1] > 0]
    total = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    host = sorted(((e.key, float(e.self_cpu_time_total), e.count)
                   for e in events
                   if str(getattr(e, "device_type", "")).endswith("CPU")),
                  key=lambda r: -r[1])
    kernels = sum(n for k, _, n in rows
                  if not k.startswith(("Memcpy", "Memset")))
    return {"wall_s": wall,
            "device_kernel_launches": kernels,
            "device_copies_and_sets": sum(n for _, _, n in rows) - kernels,
            "device_busy_s": total / 1e6 if total else None,
            "device_idle_share": (1 - total / 1e6 / wall) if total else None,
            "top_kernels": [{"name": k[:80], "device_ms": us / 1e3,
                             "count": n} for k, us, n in rows[:15]],
            "top_host_ops": [{"name": k[:60], "self_cpu_ms": us / 1e3,
                              "count": n} for k, us, n in host[:12]]}


def train_model(torch, cfg, arrays, param_dtype="bfloat16"):
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM
    from paddle_hackathon_tpu_torch.parallel import make_sharded_train_step
    from paddle_hackathon_tpu_torch.utils import load_jax_state
    model = GPTForCausalLM(cfg, device=DEV)
    load_jax_state(model, arrays)
    step, state = make_sharded_train_step(
        model, learning_rate=1e-4, grad_clip_norm=1.0,
        param_dtype=param_dtype)
    return model, step, state


def phase_train(torch, fap):
    from torch.profiler import ProfilerActivity, profile

    from paddle_hackathon_tpu_torch.models import gpt_config
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    b, s = TRAIN_SHAPE["b"], TRAIN_SHAPE["s"]
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM
    arrays = random_weights(GPTForCausalLM(cfg, device="cpu"), seed=0)
    model, step, state = train_model(torch, cfg, arrays)
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(DEV)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(DEV)
    losses = []
    for _ in range(2):                                   # warm-up
        state, loss = step(state, ids, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in fap.launches:
        fap.launches[k] = 0
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, ids, labels)
        losses.append(loss)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(fap.launches)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall on a repeated batch: "
                             f"{losses}")
    need = steps * cfg.num_layers
    if any(n != need for n in launches.values()):
        raise AssertionError(f"flash launches {launches} != {need} each")
    n_params = model.num_params()
    tps = steps * b * s / wall
    emit({"phase": "train", "model": "gpt2-small-en bf16", "batch": b,
          "seq": s, "steps": steps, "wall_s": wall,
          "ms_per_step": 1e3 * wall / steps, "tokens_per_s": tps,
          "mfu": 6 * n_params * tps / H100_BF16_FLOPS,
          "num_params": n_params, "peak_memory_gb": peak / 1e9,
          "losses": losses, "flash_launches": launches})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    emit({"phase": "train_profile", "steps": 1,
          **profile_summary(torch, prof, wall)})
    del model, step, state, prof
    torch.cuda.empty_cache()

    # flash (K1) against the plain composition, same init and batch
    series = {}
    for use_flash in (True, False):
        c = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                       attention_dropout_prob=0.0,
                       use_flash_attention=use_flash)
        m, st_fn, st = train_model(torch, c, arrays)
        out = []
        for _ in range(3):
            st, loss = st_fn(st, ids[:4], labels[:4])
            out.append(float(loss))
        series[use_flash] = out
        del m, st_fn, st
        torch.cuda.empty_cache()
    rel = max(abs(a - b) / abs(b) for a, b in zip(series[True],
                                                  series[False]))
    emit({"phase": "train_flash_vs_plain", "batch": 4, "seq": s,
          "flash": series[True], "plain": series[False],
          "max_rel_diff": rel, "rtol": FLASH_VS_PLAIN_RTOL})
    if not rel <= FLASH_VS_PLAIN_RTOL:
        raise AssertionError(f"flash and plain loss series differ by "
                             f"{rel} > {FLASH_VS_PLAIN_RTOL}: {series}")
    return launches


# ---------------------------------------------------------------------------
# The optimizer and the train step: schedulers, AdamW, Lamb, master weights
# ---------------------------------------------------------------------------

OPTIM_SHAPE = dict(b=8, s=1024)
OPTIM_STEPS = 3
# the chunked loss against the unchunked logsumexp form on the same bf16
# logits: the mean loss within 1e-6 relative (the two take each row's
# f32 sum in other orders on the card), each gradient entry within 1
# bf16 ulp (the softmax is the same f32 arithmetic; a last-bit difference
# of the row's logsumexp can move an entry across one bf16 rounding)
CE_REL_TOL = 1e-6
CE_GRAD_ULPS = 1


def no_decay(name):
    """Biases and layer norms take no weight decay (the usual AdamW
    split)."""
    return name.endswith(".bias") or ".ln_" in name


def bf16_model(torch, cfg, arrays):
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM
    from paddle_hackathon_tpu_torch.utils import load_jax_state
    model = GPTForCausalLM(cfg, device=DEV)
    load_jax_state(model, arrays)
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data.to(torch.bfloat16)
    return model


def counted_steps(torch, fap, run, layers, what):
    """Run ``run()`` (``OPTIM_STEPS`` steps, returning their losses) with
    K1's counts set to 0 just before and its plain versions counted; the
    losses must be finite and falling and each K1 kernel launched exactly
    steps x layers times, no plain call."""
    plain = {"flash_packed_fwd_ref": 0, "flash_packed_bwd_ref": 0}
    real = counting(fap, plain, plain)
    try:
        for k in fap.launches:
            fap.launches[k] = 0
        t0 = time.perf_counter()
        losses = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fap.launches)
    finally:
        restore(fap, real)
    losses = [float(x) for x in losses]
    need = OPTIM_STEPS * layers
    emit({"phase": "train_optim", "run": what, "steps": OPTIM_STEPS,
          "wall_s": wall, "losses": losses, "k1_launches": launches,
          "plain_k1_calls": plain})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"{what}: losses not finite and falling: "
                             f"{losses}")
    if any(n != need for n in launches.values()) or any(plain.values()):
        raise AssertionError(f"{what}: K1 launches {launches} != {need} "
                             f"each, or plain calls {plain}")
    return launches


def optim_functional_run(torch, model, ids, labels):
    """(a): ``make_functional_train_step`` with AdamW (biases and layer
    norms spared), ``LinearWarmup`` over ``CosineAnnealingDecay`` and
    ``ClipGradByGlobalNorm(1.0)``."""
    from paddle_hackathon_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_hackathon_tpu_torch.nn.functional import \
        fused_softmax_ce_rows
    from paddle_hackathon_tpu_torch.optimizer import AdamW, lr
    from paddle_hackathon_tpu_torch.parallel import \
        make_functional_train_step
    named = list(model.named_parameters())
    plist = [p for _, p in named]
    sched = lr.LinearWarmup(lr.CosineAnnealingDecay(1e-3, T_max=1000),
                            warmup_steps=2, start_lr=2e-4, end_lr=1e-3)
    opt = AdamW(learning_rate=sched, parameters=named, weight_decay=0.1,
                apply_decay_param_fun=lambda n: not no_decay(n),
                grad_clip=ClipGradByGlobalNorm(1.0))

    def grads_of(params, xs, ys, step):
        ps = {k: v.detach().requires_grad_() for k, v in params.items()}
        logits = torch.func.functional_call(model, ps, (xs,))
        loss = fused_softmax_ce_rows(logits, ys).mean()
        grads = torch.autograd.grad(loss, list(ps.values()))
        return loss.detach(), dict(zip(ps, grads))

    train_step = make_functional_train_step(opt, plist,
                                            [n for n, _ in named], grads_of)

    def run():
        params = {n: p.detach() for n, p in named}
        states, t, losses = opt.functional_state(plist), 0, []
        for _ in range(OPTIM_STEPS):
            params, states, t, loss = train_step(params, states, t, sched(),
                                                 (ids, labels))
            sched.step()
            losses.append(loss)
        return losses
    return run


def optim_sharded_run(torch, model, ids, labels, **kw):
    """(b), (c): ``make_sharded_train_step`` with ``kw``."""
    from paddle_hackathon_tpu_torch.parallel import make_sharded_train_step
    step, state = make_sharded_train_step(model, **kw)

    def run():
        st, losses = state, []
        for _ in range(OPTIM_STEPS):
            st, loss = step(st, ids, labels)
            losses.append(loss)
        return losses
    return run


def bits_differ(torch, a, b):
    view = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return not torch.equal(a.view(view[a.dtype]), b.view(view[b.dtype]))


def adam_multi_vs_per_tensor(torch, model):
    """Two steps of Adam and of AdamW (the decay mask and the clip) on the
    model's bf16 parameters and gradients: the multi-tensor update
    against the per-tensor rule, values and moments bit for bit; each
    path's wall time (host launches and device work)."""
    from paddle_hackathon_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_hackathon_tpu_torch.optimizer import Adam, AdamW, Optimizer
    named = list(model.named_parameters())
    plist = [p for _, p in named]
    vals = [p.detach() for p in plist]
    grads = [p.grad for p in plist]
    n = len(plist)
    out = {}
    for name, opt in (
            ("adam", Adam(learning_rate=1e-3, parameters=named)),
            ("adamw", AdamW(learning_rate=1e-3, parameters=named,
                            weight_decay=0.1,
                            apply_decay_param_fun=lambda k: not no_decay(k),
                            grad_clip=ClipGradByGlobalNorm(1.0)))):
        states, differ, times = opt.functional_state(plist), 0, {}
        for t in (1, 2):
            runs = {}
            for path, fn in (("multi", opt.functional_update),
                             ("per_tensor", lambda *a, **k:
                              Optimizer._update_all(opt, *a, (1.0,) * n,
                                                    k["params"]))):
                ms = []
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    runs[path] = fn(vals, grads, states, 1e-3, t,
                                    params=plist)
                    torch.cuda.synchronize()
                    ms.append(1e3 * (time.perf_counter() - t0))
                times[f"{path}_ms_t{t}"] = sorted(ms)[1]
            (mv, ms_), (sv, ss) = runs["multi"], runs["per_tensor"]
            differ += sum(bits_differ(torch, a, b) for a, b in zip(mv, sv))
            differ += sum(bits_differ(torch, a[k], b[k])
                          for a, b in zip(ms_, ss) for k in a)
            states = ms_      # the second step from the first's moments
        out[name] = {"tensors": n, "tensors_differing": differ, **times}
    emit({"phase": "train_optim_adam_bits", **out})
    if any(r["tensors_differing"] for r in out.values()):
        raise AssertionError(f"multi-tensor Adam differs from the "
                             f"per-tensor rule: {out}")


def ulps_bf16(torch, a, b):
    """Largest distance in bf16 steps between two bf16 tensors (+0 and
    -0 one point)."""
    def key(t):
        i = t.view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return int((key(a) - key(b)).abs().max())


def chunked_loss_check(torch, model, ids, labels):
    """``fused_softmax_ce_rows`` on the model's bf16 logits against the
    unchunked ``logsumexp(x.f32) - x[label].f32`` form: the mean loss,
    every gradient entry in bf16 ulps, and each form's peak memory and
    wall time for forward and backward."""
    from paddle_hackathon_tpu_torch.nn.functional import \
        fused_softmax_ce_rows
    with torch.no_grad():
        x = model(ids).reshape(-1, model.config.vocab_size)
    lbl = labels.reshape(-1)
    forms = {
        "chunked": lambda z: fused_softmax_ce_rows(z, lbl),
        "unchunked": lambda z: torch.logsumexp(z.float(), dim=-1)
        - z.gather(-1, lbl[:, None]).squeeze(-1).float()}
    got = {}
    for name, fn in forms.items():
        z = x.clone().requires_grad_()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = fn(z).mean()
        loss.backward()
        torch.cuda.synchronize()
        got[name] = {"loss": float(loss.detach()), "grad": z.grad,
                     "wall_ms": 1e3 * (time.perf_counter() - t0),
                     "peak_above_inputs_gb":
                         (torch.cuda.max_memory_allocated() - base) / 1e9}
        del z, loss
    a, b = got["chunked"], got["unchunked"]
    rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    ulps = ulps_bf16(torch, a["grad"], b["grad"])
    emit({"phase": "train_optim_loss", "rows": x.shape[0],
          "vocab": x.shape[1], "rel_diff": rel, "rel_tol": CE_REL_TOL,
          "grad_max_ulps": ulps, "ulp_tol": CE_GRAD_ULPS,
          "grad_entries_differing": int((a["grad"] != b["grad"]).sum()),
          **{f"{k}_{f}": got[k][f] for k in got
             for f in ("loss", "wall_ms", "peak_above_inputs_gb")}})
    if not rel <= CE_REL_TOL or ulps > CE_GRAD_ULPS:
        raise AssertionError(f"chunked loss off the unchunked form: rel "
                             f"{rel}, {ulps} bf16 ulps")


def phase_train_optim(torch, fap):
    """GPT-2-small in bf16 at b=8, s=1024 (random weights from the numpy
    seed, as ``train``) through the optimizer and step paths: (a)
    ``make_functional_train_step`` with AdamW, a scheduler and a global
    clip; (b) ``make_sharded_train_step(optimizer="lamb")``; (c)
    ``make_sharded_train_step(master_weights=True)``; 3 steps each on one
    repeated batch.  Then the multi-tensor Adam against the per-tensor
    rule and the chunked loss against the unchunked form, on (c)'s
    model."""
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    arrays = random_weights(GPTForCausalLM(cfg, device="cpu"), seed=0)
    b, s = OPTIM_SHAPE["b"], OPTIM_SHAPE["s"]
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(DEV)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(DEV)
    launches = {}
    for what, make in (
            ("functional_adamw", lambda m: optim_functional_run(
                torch, m, ids, labels)),
            ("sharded_lamb", lambda m: optim_sharded_run(
                torch, m, ids, labels, learning_rate=1e-2,
                optimizer="lamb")),
            ("sharded_master_weights", lambda m: optim_sharded_run(
                torch, m, ids, labels, learning_rate=1e-3,
                master_weights=True))):
        model = bf16_model(torch, cfg, arrays)
        launches[what] = counted_steps(torch, fap, make(model),
                                       cfg.num_layers, what)
        if what != "sharded_master_weights":
            del model
            torch.cuda.empty_cache()
    from paddle_hackathon_tpu_torch.nn.functional import \
        fused_softmax_ce_rows
    fused_softmax_ce_rows(model(ids), labels).mean().backward()
    adam_multi_vs_per_tensor(torch, model)
    model.zero_grad(set_to_none=True)
    chunked_loss_check(torch, model, ids, labels)
    del model
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# K2: the bhd flash-attention kernels, and f32 training through SDPA
# ---------------------------------------------------------------------------

# K2 limits.  bf16/f16: K1's (``FLASH_TOL``) against the plain version in
# f32.  f32: against the plain version in f64, relative L2 1e-4 per slice,
# worst row 2e-3 (K1's 20x between the two readings), LSE 1e-5 absolute.
# Each case also reads the control (the plain version in the input's
# dtype; for f32 the plain f32 version against f64) and the planted fault
# (kv tile 1 a stale copy of tile 0); each f32 case also reads the plain
# version on operands rounded to TF32's 10-bit mantissa, which must fail:
# a kernel that ran its products in TF32 would not pass.
FLASH_F32_TOL = {"rel": 1e-4, "row": 2e-3, "lse": 1e-5}
BHD_TRAIN_SHAPE = dict(b=16, s=1024, H=12, D=64)     # the f32 train step
F32_FLASH_VS_PLAIN_RTOL = 1e-4
# the f32 dK/dV and dQ pair (3xTF32 on the tensor cores) against the plain
# version in f64: relative L2 of dq, dk and dv, the largest of the three.
# On the H100 the pair reads 4.2e-7 to 5.1e-7 over the f32 cases at
# D <= 256, the plain pair on operands split by truncation (raw f32 read
# as hi) 7.1e-7 to 1.02e-6, and 1xTF32 above 1e-4: the limit lies between
# the first two (1e-6 let most truncated readings pass).  It holds up to
# D = 512 and the padded 514, where the truncated control still fails it
# (bh=2, s=256 on the CPU, tests/test_torch_wide_bwd.py: 8.9e-7 at 512, to
# nearest 5.1e-7); from D = 1024 pairs keep FLASH_F32_TOL.
FLASH_F32_PAIR_REL = 6e-7


def bhd_case(torch, bh, sq, skv, D, dtype, seed):
    """Random q, dO (bh, sq, D) and k, v (bh, skv, D) on the card."""
    rng = np.random.RandomState(seed)
    mk = lambda s, sc=1.0: torch.from_numpy(  # noqa: E731
        (rng.randn(bh, s, D) * sc).astype(np.float32)).to(DEV, dtype)
    return mk(sq, 0.5), mk(skv, 0.5), mk(skv), mk(sq)


def bhd_slices(out, lse, dq, dk, dv):
    """O, LSE, dQ, dK and dV in f64, each row a D-vector."""
    return {"out": out.double(), "lse": lse.double(), "dq": dq.double(),
            "dk": dk.double(), "dv": dv.double()}


def bhd_plain(fa, q, k, v, do, causal, scale, p=0.0, seed=None):
    """The plain forward and backward in the inputs' own dtype (f64 for
    f64)."""
    out, lse = fa.flash_fwd_ref(q, k, v, causal, scale, p, seed)
    acc = fa._acc(q.dtype)
    delta = (do.to(acc) * out.to(acc)).sum(-1)
    grads = fa.flash_bwd_pair_ref(q, k, v, do, lse, delta, causal, scale, p,
                                  seed)
    return bhd_slices(out, lse, *grads)


def tf32_trunc_split(torch, x):
    """``fa.tf32_split`` with truncation in place of round-to-nearest: hi
    is x with its low 13 mantissa bits cleared, as the tensor core reads
    raw f32, and lo the same of x - hi."""
    def trunc(t):
        return (t.contiguous().view(torch.int32) & ~0x1FFF).view(
            torch.float32)
    hi = trunc(x.float())
    return hi, trunc(x.float() - hi)


def split_pair(torch, fa, split, q, k, v, do, lse, delta, causal, scale,
               p=0.0, seed=None):
    """The plain f32 pair (``flash_bwd_pair_ref``) with every product taken
    as the 3xTF32 kernels take it: al.bh + ah.bl + ah.bh from ``split``'s
    operands, one f32 sum over the three (the operands stacked along the
    contracted axis); P and dS split as the kernels split them."""
    def mm(eq, a, b, axis_a, axis_b):
        (ah, al), (bh_, bl) = split(a), split(b)
        return torch.einsum(eq, torch.cat([al, ah, ah], axis_a),
                            torch.cat([bh_, bl, bh_], axis_b))
    bh, sq, _ = q.shape
    skv = k.shape[1]
    pr = torch.exp(mm("bqd,bkd->bqk", q, k, 2, 2) * scale - lse[..., None])
    if causal:
        pr = pr.masked_fill(~fa._causal(sq, skv, q.device), 0.0)
    dp = mm("bqd,bkd->bqk", do, v, 2, 2)
    pv = pr
    if p > 0.0:
        keep = fa._drop_mask(bh, sq, skv, seed, p, q.device)
        pv = torch.where(keep, pr / (1.0 - p), 0.0)
        dp = torch.where(keep, dp / (1.0 - p), 0.0)
    dv = mm("bqk,bqd->bkd", pv, do, 1, 1)
    ds = pr * (dp - delta[..., None]) * scale
    return (mm("bqk,bkd->bqd", ds, k, 2, 1), mm("bqk,bqd->bkd", ds, q, 1, 1),
            dv)


def split_fwd(torch, fa, split, q, k, v, causal, scale, p=0.0, seed=None):
    """The plain f32 forward (``flash_fwd_ref``) with S and P.V taken as
    the 3xTF32 kernel takes them, from ``split``'s operands (as
    :func:`split_pair`): returns O."""
    def mm(eq, a, b, axis_a, axis_b):
        (ah, al), (bh_, bl) = split(a), split(b)
        return torch.einsum(eq, torch.cat([al, ah, ah], axis_a),
                            torch.cat([bh_, bl, bh_], axis_b))
    bh, sq, _ = q.shape
    skv = k.shape[1]
    sc = mm("bqd,bkd->bqk", q, k, 2, 2) * scale
    if causal:
        mask = fa._causal(sq, skv, q.device)
        sc = sc.masked_fill(~mask, -1e30)
    m = sc.amax(-1, keepdim=True)
    pr = torch.exp(sc - m)
    if causal:
        pr = pr.masked_fill(~mask, 0.0)
    l = pr.sum(-1, keepdim=True)
    if p > 0.0:
        keep = fa._drop_mask(bh, sq, skv, seed, p, q.device)
        pr = torch.where(keep, pr / (1.0 - p), 0.0)
    return mm("bqk,bkd->bqd", pr, v, 2, 1) / torch.where(l == 0.0, 1.0, l)


def bhd_stale(t, tile=64):
    """The planted fault's k or v: tile 1 replaced by tile 0."""
    bad = t.clone()
    bad[:, tile:2 * tile] = t[:, :tile]
    return bad


def ring_grads(torch, fa, q, k, v, do, lse, delta, causal, scale):
    """(dq, dk, dv) from ``_bwd_pair`` over kv halves, given the global
    LSE and Δ: non-causal, the whole q against each half (dq sums, dk and
    dv concatenate); causal, the two-device ring layout (q half i against
    kv half j <= i, causal only on the diagonal)."""
    h = k.shape[1] // 2
    halves = (slice(0, h), slice(h, None))
    whole = slice(None)
    pairs = ([(whole, halves[0], False), (whole, halves[1], False)]
             if not causal else
             [(halves[0], halves[0], True), (halves[1], halves[0], False),
              (halves[1], halves[1], True)])
    dq = torch.zeros_like(q, dtype=torch.float32)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    c = lambda t, sl: t[:, sl].contiguous()  # noqa: E731
    for qs, ks, diag in pairs:
        a, b, e = fa._bwd_pair(c(q, qs), c(k, ks), c(v, ks), c(do, qs),
                               c(lse, qs), c(delta, qs), diag, scale)
        dq[:, qs] += a.float()
        dk[:, ks] += b.float()
        dv[:, ks] += e.float()
    return dq, dk, dv


def bshd_fused_grads(torch, tF, q, k, v, do, b, causal, scale, p, seed):
    """O and (dq, dk, dv) in (bh, s, D) through the public entry point
    ``flash_attention_bshd``, with q, k and v strided views of one fused
    (b, s, 3, H, D) projection, as GPT's qkv hands them over."""
    bh, s, D = q.shape
    H = bh // b
    to_bshd = lambda t: t.reshape(b, H, s, D).transpose(1, 2)  # noqa: E731
    to_bhd = lambda t: t.transpose(1, 2).reshape(bh, s, D)  # noqa: E731
    fused = torch.stack([to_bshd(t) for t in (q, k, v)], 2).requires_grad_()
    out = tF.flash_attention_bshd(fused[:, :, 0], fused[:, :, 1],
                                  fused[:, :, 2], causal, scale, p, seed)
    out.backward(to_bshd(do))
    return (to_bhd(out.detach()),
            [to_bhd(fused.grad[:, :, i]) for i in range(3)])


def phase_flash_bhd_checks(torch, fa):
    import math

    from paddle_hackathon_tpu_torch.incubate.nn import functional as tF
    torch.backends.cuda.matmul.allow_tf32 = False
    checks, train_readings = [], {}

    def check(name, bh, sq, skv, D, causal, dtype, p=0.0, seed=None,
              ring=False, fused_b=None):
        before = dict(fa.fwd_launches, **fa.bwd_launches)
        q, k, v, do = bhd_case(torch, bh, sq, skv, D, dtype, len(checks))
        scale = 1.0 / math.sqrt(D)
        out, lse = fa.flash_fwd_kernel(q, k, v, causal, scale, p, seed)
        if fused_b:
            out, grads = bshd_fused_grads(torch, tF, q, k, v, do, fused_b,
                                          causal, scale, p, seed)
        elif ring:
            delta = (do.float() * out.float()).sum(-1)
            grads = ring_grads(torch, fa, q, k, v, do, lse, delta, causal,
                               scale)
        else:
            xs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            fa.flash_attention_bhd(*xs, causal, scale, p, seed).backward(do)
            grads = [x.grad for x in xs]
        torch.cuda.synchronize()
        f32 = dtype == torch.float32
        wide = torch.float64 if f32 else torch.float32
        args = (causal, scale, p, seed)
        ref = bhd_plain(fa, q.to(wide), k.to(wide), v.to(wide), do.to(wide),
                        *args)
        got = {"kernel": bhd_slices(out, lse, *grads),
               "control": bhd_plain(fa, q, k, v, do, *args),
               "fault": bhd_plain(fa, q, bhd_stale(k), bhd_stale(v), do,
                                  *args)}
        if f32:
            # operands rounded to TF32 (the 3xTF32 split's hi part)
            got["tf32"] = bhd_plain(fa, *(fa.tf32_split(t)[0]
                                          for t in (q, k, v, do)), *args)
        tol = FLASH_F32_TOL if f32 else FLASH_TOL
        r = {key: flash_readings(val, ref, live_floor=True)
             for key, val in got.items()}
        ref_g = {sl: ref[sl] for sl in ("dq", "dk", "dv")}
        ref_o = ref["out"]
        del ref, got
        ok = (flash_within(r["kernel"], tol)
              and flash_within(r["control"], tol)
              and not flash_within(r["fault"], tol)
              and not (f32 and flash_within(r["tf32"], tol)))
        extra = {}
        if f32:
            # the forward twice more, bit for bit; and on D <= 256 with
            # rows TMA addresses (the 3xTF32 forward) its O reading beside
            # the plain forward on 3xTF32 operands split to nearest and by
            # truncation
            reps = [fa.flash_fwd_kernel(q, k, v, causal, scale, p, seed)
                    for _ in range(2)]
            torch.cuda.synchronize()
            fwd_same = all(torch.equal(a, b) for a, b in zip(*reps))
            ok = ok and fwd_same
            extra["fwd_bitwise_repeat"] = fwd_same
            if D <= 256 and D % 4 == 0:
                extra["fwd_rel"] = r["kernel"]["out"]["rel"]
                for key, fn in (("rna", fa.tf32_split),
                                ("trunc",
                                 lambda t: tf32_trunc_split(torch, t))):
                    o = split_fwd(torch, fa, fn, q, k, v, *args)
                    extra[f"fwd_split_{key}_rel"] = float(
                        (o.double() - ref_o).norm() / ref_o.norm())
            del reps
        if D != fa.padded_width(D, dtype) or D > 256:
            extra["fwd_kernel"] = fa.library_fwd_route(D, dtype)
            extra["bwd_route"] = fa.library_bwd_route(D, dtype)
        if not f32:
            # bf16/f16 on the tensor cores (flash_tc.cuh up to 256,
            # flash_wide.cuh past it): the pair three times, bit for bit
            # alike and (through autograd's own pair) the same as the
            # gradient; up to 256 the forward twice more, bit for bit
            delta = (do.float() * out.float()).sum(-1)
            runs = [fa._bwd_pair(q, k, v, do, lse, delta, causal, scale, p,
                                 seed) for _ in range(3)]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for run in runs[1:]
                       for a, b in zip(run, runs[0]))
            if not (ring or fused_b):
                same = same and all(torch.equal(a, b)
                                    for a, b in zip(runs[0], grads))
            extra["pair_bitwise_repeat"] = same
            ok = ok and same
            del runs, delta
            if fa.fwd_route(D, dtype) == "fwd_tc16":
                reps = [fa.flash_fwd_kernel(q, k, v, causal, scale, p, seed)
                        for _ in range(3)]
                torch.cuda.synchronize()
                extra["fwd_bitwise_repeat"] = all(
                    torch.equal(u, w) for rep in reps[1:]
                    for u, w in zip(rep, reps[0]))
                ok = ok and extra["fwd_bitwise_repeat"]
                del reps
        if fa.fwd_route(D, dtype) == "wide_fwd_tc":
            # the column-chunked forward on the tensor cores: twice more bit
            # for bit (f32 above), and on a V whose chunks repeat, every
            # chunk of O the first's
            cc = fa.wide_fwd_plan(bh, sq, D, dtype)["chunk_cols"]
            if not f32:
                reps = [fa.flash_fwd_kernel(q, k, v, causal, scale, p, seed)
                        for _ in range(2)]
                extra["fwd_bitwise_repeat"] = all(
                    torch.equal(u, w) for rep in reps
                    for u, w in zip(rep, (out, lse)))
                del reps
            o_rep = fa.flash_fwd_kernel(q, k, repeat_chunks(v, D, cc),
                                        causal, scale, p, seed)[0]
            torch.cuda.synchronize()
            extra["chunks_share_row_stats"] = chunks_equal(o_rep, D, cc)
            ok = (ok and extra["fwd_bitwise_repeat"]
                  and extra["chunks_share_row_stats"])
            del o_rep
        if f32:
            # the 3xTF32 pair's own limit up to D = 512, and its repeats
            # bit for bit
            pair_rel = max(r["kernel"][sl]["rel"] for sl in ("dq", "dk",
                                                             "dv"))
            delta = (do * out).sum(-1)
            runs = [fa._bwd_pair(q, k, v, do, lse, delta, causal, scale, p,
                                 seed) for _ in range(3)]
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for run in runs[1:]
                       for a, b in zip(runs[0], run))
            # the plain pair on 3xTF32 operands on the same inputs: split
            # to nearest (the kernels' split) and, the control that must
            # fail the limit, by truncation (raw f32 read as hi)
            split = {"rna": fa.tf32_split,
                     "trunc": lambda t: tf32_trunc_split(torch, t)}
            emu = {key: max(float((g.double() - ref_g[sl]).norm()
                                  / ref_g[sl].norm())
                            for g, sl in zip(split_pair(
                                torch, fa, fn, q, k, v, do, lse, delta,
                                causal, scale, p, seed), ("dq", "dk", "dv")))
                   for key, fn in split.items()}
            ok = ok and same
            if D < 1024:
                # the pair's limit up to D = 512 and the padded D = 514
                # (at 516); the emulation split to nearest is read, not
                # held: its own f32 sums (3 D-long or 1000-row
                # contractions) read up to 7.9e-7 on the card
                ok = (ok and pair_rel <= FLASH_F32_PAIR_REL
                      and emu["trunc"] > FLASH_F32_PAIR_REL)
            extra.update({"pair_rel": pair_rel, "pair_bitwise_repeat": same,
                          "split_rna_rel": emu["rna"],
                          "split_trunc_rel": emu["trunc"]})
            del runs
        if (f32 and D > 256) or fa.fwd_route(D, dtype) == "fwd_tc16":
            # past 256 the f32 case launches the tensor-core forward and
            # the 3xTF32 dK/dV and dQ (bhd_*_tc<0>) and no other kernel;
            # bf16/f16 up to 256 flash_tc.cuh's three kernels and no other
            launched = {key: n - before[key] for key, n in
                        dict(fa.fwd_launches, **fa.bwd_launches).items()}
            want = (("wide_fwd_tc", "dkdv_wide_tc_f32", "dq_wide_tc_f32")
                    if f32 else ("fwd_tc16", "dkdv_tc16", "dq_tc16"))
            extra["launches"] = launched
            ok = ok and all(launched[key] >= 1 for key in want) and not any(
                n for key, n in launched.items() if key not in want)
        del ref_g, ref_o
        checks.append({"case": name, "ok": ok, **extra, **{
            key: [val["lse"]] + [val[sl][m] for sl in FLASH_SLICES
                                 for m in ("rel", "row")]
            for key, val in r.items()}})
        return r["kernel"]

    f32, bf16, f16 = torch.float32, torch.bfloat16, torch.float16
    for dt, tag in ((f32, "f32"), (bf16, "bf16"), (f16, "f16")):
        check(f"{tag}_causal_bh8_s256", 8, 256, 256, 64, True, dt)
        check(f"{tag}_dropout0.1", 8, 256, 256, 64, True, dt, 0.1, 1234)
        check(f"{tag}_sq256_skv1024", 4, 256, 1024, 64, True, dt)
        check(f"{tag}_sq1024_skv256", 4, 1024, 256, 64, True, dt)
        check(f"{tag}_ragged_s1000", 4, 1000, 1000, 64, True, dt)
        check(f"{tag}_noncausal", 8, 256, 256, 64, False, dt)
        check(f"{tag}_noncausal_dropout0.1", 4, 192, 192, 64, False, dt,
              0.1, -7)
        check(f"{tag}_ragged_s1000_noncausal", 2, 1000, 1000, 64, False, dt)
        # past 256 the forward on the tensor cores (bf16/f16: 256-column
        # chunks of 64-column slices, D = 264 a slice of 8 columns, q
        # resident up to 1024; f32: 128-column chunks of 32-column slices)
        # and the column-chunked backward on the tensor cores (bf16/f16
        # 256-column chunks; f32 3xTF32, 128 columns of dK and dV, 256 of
        # dQ a block)
        for D in (32, 80, 128, 256, 36, 264, 320, 384, 512, 1024):
            check(f"{tag}_d{D}", 4 if D > 512 else 8, 256, 256, D, True, dt)
        check(f"{tag}_ring_kv_halves", 8, 512, 512, 64, False, dt,
              ring=True)
    check("f32_ring_causal", 8, 512, 512, 64, True, f32, ring=True)
    # the tensor-core backward past 256 with dropout, and sq != skv
    check("bf16_d320_dropout0.1", 8, 256, 256, 320, True, bf16, 0.1, 41)
    check("f16_d512_noncausal_dropout0.1_sq256_skv512", 4, 256, 512, 512,
          False, f16, 0.1, 42)
    check("bf16_d264_dropout0.1_sq512_skv256", 4, 512, 256, 264, True, bf16,
          0.1, 43)
    # bf16 D = 100 (200-byte rows, zero-padded to 104 onto flash_tc.cuh's
    # 128-wide kernels) with dropout and kv rows past the last q row
    # (causal: their dK and dV blocks write zeros)
    check("bf16_d100_dropout0.1_sq256_skv512", 4, 256, 512, 100, True, bf16,
          0.1, 44)
    # rows TMA cannot address, zero-padded onto the tensor-core kernels:
    # f32 D = 33 (132 bytes: the 3xTF32 kernels at 36), bf16 D = 514 (the
    # forward and the pair at 520); and f32 D = 1032, a row TMA addresses
    # whose last 128-column chunk holds 8 columns
    check("f32_d33", 8, 256, 256, 33, True, f32)
    check("bf16_d514", 4, 256, 256, 514, True, bf16)
    check("f32_d1032", 2, 256, 256, 1032, True, f32)
    check("f32_d264_dropout0.1_sq256_skv512", 4, 256, 512, 264, True, f32,
          0.1, 77)
    check("f32_d512_dropout0.1_sq512_skv256", 2, 512, 256, 512, True, f32,
          0.1, 78)
    # f32 D = 514 (2056-byte rows, which TMA cannot address): the forward,
    # dK/dV and dQ run the tensor-core kernels at 516 and no other (the
    # launch check of every f32 case past 256, in check)
    check("f32_d514", 4, 256, 256, 514, True, f32)
    # batch 1 through the public entry point, on strided views of one fused
    # projection: the (b, s, H, D) -> (b*H, s, D) move must hand the kernels
    # contiguous tensors also where the reshape could merge a size-1 dim
    check("f32_bshd_b1_fused_views", 12, 1024, 1024, 64, True, f32,
          fused_b=1)
    check("bf16_bshd_b1_h1_fused_views", 1, 256, 256, 64, True, bf16,
          fused_b=1)
    b, s, H, D = (BHD_TRAIN_SHAPE[k] for k in "bsHD")
    train_readings = check("f32_train_geometry_bh192_s1024", b * H, s, s, D,
                           True, f32)
    torch.cuda.empty_cache()

    def check_many_heads(name, dtype, bh=65538, s=8, D=64):
        # b*H past 65535, grid.y's limit: the last two heads' forward and
        # dK/dV + dQ pair against the plain version; the planted fault is
        # the plain version of the heads before, as a kernel that wrapped
        # bh would read them
        gen = torch.Generator(device=DEV).manual_seed(len(checks))
        q, k, v, do = ((torch.randn(bh, s, D, generator=gen, device=DEV)
                        * sc).to(dtype) for sc in (0.5, 0.5, 1.0, 1.0))
        scale = 1.0 / math.sqrt(D)
        counts = dict(fa.fwd_launches, **fa.bwd_launches)
        out, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
        delta = (do.float() * out.float()).sum(-1)
        grads = fa._bwd_pair(q, k, v, do, lse, delta, True, scale)
        torch.cuda.synchronize()
        launched = {key: n - counts[key] for key, n in
                    dict(fa.fwd_launches, **fa.bwd_launches).items()}
        tail, before = slice(bh - 2, bh), slice(bh - 3, bh - 1)
        f32 = dtype == torch.float32
        extra = {}
        if not f32:
            # flash_tc.cuh's three kernels alone, and twice more bit for bit
            want = ("fwd_tc16", "dkdv_tc16", "dq_tc16")
            extra["launches_ok"] = all(
                (n == 1) == (key in want) for key, n in launched.items())
            reps = [(*fa.flash_fwd_kernel(q, k, v, True, scale),
                     *fa._bwd_pair(q, k, v, do, lse, delta, True, scale))
                    for _ in range(2)]
            torch.cuda.synchronize()
            extra["bitwise_repeat"] = all(
                torch.equal(a, b) for rep in reps
                for a, b in zip(rep, (out, lse, *grads)))
            del reps
        wide = torch.float64 if f32 else torch.float32
        ref = bhd_plain(fa, *(t[tail].to(wide) for t in (q, k, v, do)), True,
                        scale)
        got = {"kernel": bhd_slices(out[tail], lse[tail],
                                    *(g[tail] for g in grads)),
               "control": bhd_plain(fa, *(t[tail] for t in (q, k, v, do)),
                                    True, scale),
               "fault": bhd_plain(fa, *(t[before] for t in (q, k, v)),
                                  do[tail], True, scale)}
        if f32:
            got["tf32"] = bhd_plain(fa, *(fa.tf32_split(t[tail])[0]
                                          for t in (q, k, v, do)), True,
                                    scale)
        tol = FLASH_F32_TOL if f32 else FLASH_TOL
        r = {key: flash_readings(val, ref, live_floor=True)
             for key, val in got.items()}
        ok = (flash_within(r["kernel"], tol)
              and flash_within(r["control"], tol)
              and not flash_within(r["fault"], tol)
              and not (f32 and flash_within(r["tf32"], tol))
              and all(extra.values()))
        checks.append({"case": name, "ok": ok, **extra, **{
            key: [val["lse"]] + [val[sl][m] for sl in FLASH_SLICES
                                 for m in ("rel", "row")]
            for key, val in r.items()}})
        del q, k, v, do, out, lse, delta, grads, ref, got

    check_many_heads("f32_bh65538_s8_d64", f32)
    check_many_heads("bf16_bh65538_s8_d64", bf16)
    torch.cuda.empty_cache()
    # the pure-Python mirror of the routes and launch plans (which the CPU
    # tests hold to the card's limits) against the libraries' own answers:
    # K2's forward and backward routes (at the padded width) and its
    # forward's shared memory per dtype and width, and past 256 its dK/dV
    # and dQ plans' shared memory; K1's forward and backward shared memory
    # per width up to the JAX plan's 8192
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        flash_attention_packed as fap
    wrong = []
    for dt in (f32, bf16, f16):
        for D in (33, 36, 64, 100, 128, 200, 256, 264, 320, 384, 512, 514,
                  516, 1024, 1032, 2048):
            got = (fa.library_fwd_route(D, dt), fa.library_fwd_smem(D, dt),
                   fa.library_bwd_route(D, dt))
            tc16 = got[0] == "fwd_tc16"
            smem = (fa.wide_fwd_plan(1, 64, D, dt)["smem"]
                    if got[0] == "wide_fwd_tc" else
                    fa.tc16_smem(D, "fwd") if tc16 else got[1])
            want = (fa.fwd_route(D, dt), smem, fa.bwd_route(D, dt))
            if D > 256 or tc16:
                got += tuple(fa.library_bwd_smem(D, dt, kn)
                             for kn in ("dkdv", "dq"))
                want += tuple(fa.tc16_smem(D, kn) if tc16 else
                              fa.wide_bwd_plan(1, 64, D, dt, kn)["smem"]
                              for kn in ("dkdv", "dq"))
            if got != want:
                wrong.append((str(dt), D, got, want))
    for D in (264, 320, 512, 1024, 1032, 2048, 8192):
        got = (fap.library_fwd_smem(D), fap.library_bwd_smem(D, "dkdv"),
               fap.library_bwd_smem(D, "dq"))
        want = (fap.fwd_plan(1, 64, 1, D, bf16)["smem"],
                fap.bwd_plan(1, 64, 1, D, bf16, "dkdv")["smem"],
                fap.bwd_plan(1, 64, 1, D, bf16, "dq")["smem"])
        if got != want:
            wrong.append(("k1", D, got, want))
    checks.append({"case": "fwd_plan_mirror", "ok": not wrong,
                   "mismatches": wrong})
    emit({"phase": "flash_bhd_checks",
          "tolerances": {"f32": FLASH_F32_TOL, "bf16_f16": FLASH_TOL,
                         "f32_pair_rel_d_below_1024": FLASH_F32_PAIR_REL},
          "fields": ["lse"] + [f"{sl}_{m}" for sl in FLASH_SLICES
                               for m in ("rel", "row")],
          "checks": checks})
    bad = [c["case"] for c in checks if not c["ok"]]
    if bad:
        raise AssertionError(f"bhd flash kernels disagree with their plain "
                             f"versions, or the limits do not separate the "
                             f"control from the planted fault: {bad}")
    return train_readings


def phase_flash_bhd(torch, fa, fap, readings):
    """K2's times at the f32 train step's shape beside their bounds, plain
    versions and the library; then the bf16 instance beside K1 at K1's
    timing shape."""
    import math

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, H, D = (BHD_TRAIN_SHAPE[k] for k in "bsHD")
    bh, scale = b * H, 1.0 / math.sqrt(D)
    q, k, v, do = bhd_case(torch, bh, s, s, D, torch.float32, seed=200)
    out, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
    delta = (do * out).sum(-1)
    ms = {
        "fwd": device_ms(torch, [
            lambda: fa.flash_fwd_kernel(q, k, v, True, scale)]),
        "dkdv": device_ms(torch, [lambda: fa.flash_dkdv_kernel(
            q, k, v, do, lse, delta, True, scale)]),
        "dq": device_ms(torch, [lambda: fa.flash_dq_kernel(
            q, k, v, do, lse, delta, True, scale)]),
    }
    plain_fwd = device_ms(torch, [
        lambda: fa.flash_fwd_ref(q, k, v, True, scale)], reps=2)
    plain_bwd = device_ms(torch, [lambda: fa.flash_bwd_pair_ref(
        q, k, v, do, lse, delta, True, scale)], reps=2)
    torch.cuda.empty_cache()

    # the library yardstick, pinned to one backend: PyTorch's f32 SDPA on
    # (b, H, s, D); its error against the f64 plain version beside its time
    qh, kh, vh, doh = (t.reshape(b, H, s, D) for t in (q, k, v, do))
    backend = SDPBackend.EFFICIENT_ATTENTION
    with sdpa_kernel(backend):
        with torch.no_grad():
            lib_fwd = device_ms(torch, [lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)])
        xs = [t.detach().clone().requires_grad_(True) for t in (qh, kh, vh)]
        og = F.scaled_dot_product_attention(*xs, is_causal=True)
        lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
            og, xs, doh, retain_graph=True))
        lib_grads = torch.autograd.grad(og, xs, doh)
    ref = bhd_plain(fa, q.double(), k.double(), v.double(), do.double(), True,
                    scale)
    lib = bhd_slices(og.detach().reshape(bh, s, D), ref["lse"],
                     *(g.reshape(bh, s, D) for g in lib_grads))
    lib_read = flash_readings(lib, ref, live_floor=True)
    del ref, lib, og, xs, lib_grads
    torch.cuda.empty_cache()

    # the pair three times more: bit-identical
    runs = [(*fa.flash_dkdv_kernel(q, k, v, do, lse, delta, True, scale),
             fa.flash_dq_kernel(q, k, v, do, lse, delta, True, scale))
            for _ in range(3)]
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a, b) for run in runs[1:]
                  for a, b in zip(runs[0], run))
    del runs
    if not bitwise:
        raise AssertionError("the f32 dK/dV and dQ kernels gave two "
                             "different results on one input")
    bounds, f32_bounds = bhd_bounds(b, s, H, D, q, out, lse)
    plain = {"fwd": plain_fwd, "dkdv": plain_bwd, "dq": plain_bwd}
    library = {"fwd": lib_fwd, "dkdv": lib_bwd, "dq": lib_bwd}
    errs = {"fwd": readings["out"]["max_abs"],
            "dkdv": max(readings["dk"]["max_abs"], readings["dv"]["max_abs"]),
            "dq": readings["dq"]["max_abs"]}
    rows, timing = {}, {}
    for key in ("fwd", "dkdv", "dq"):
        b_ms, b_by, flops, nbytes = bounds[key]
        rows[key] = {"max_abs_err": errs[key], "ms": ms[key],
                     "plain_ms": plain[key], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": library[key]}
        timing[key] = dict(rows[key], gflop=flops / 1e9,
                           gbytes=nbytes / 1e9,
                           tflops=flops / ms[key] / 1e9,
                           f32_cuda_core_bound_ms=f32_bounds[key][0])
    # the forward's error against f64 beside SDPA's own
    timing["fwd"].update(
        out_rel_vs_f64=readings["out"]["rel"], lse_vs_f64=readings["lse"],
        sdpa_out_rel_vs_f64=lib_read["out"]["rel"],
        sdpa_lse_vs_f64=lib_read["lse"])
    pair = ms["dkdv"] + ms["dq"]
    pair_row = {"ms": pair, "sdpa_f32_backward_ms": lib_bwd,
                "over_sdpa": pair / lib_bwd,
                "bound_3xtf32_ms": bounds["dkdv"][0] + bounds["dq"][0],
                "bound_f32_cuda_cores_ms": f32_bounds["dkdv"][0]
                + f32_bounds["dq"][0],
                "plain_ms": plain_bwd, "bitwise_repeat": bitwise,
                "kernel_readings_vs_f64": {
                    sl: readings[sl]["rel"] for sl in ("dq", "dk", "dv")},
                "sdpa_readings_vs_f64": {
                    sl: lib_read[sl]["rel"] for sl in ("dq", "dk", "dv")}}
    del q, k, v, do, out, lse, delta, qh, kh, vh, doh
    torch.cuda.empty_cache()

    # the bf16 instance beside K1, at K1's timing shape (b=32), from the
    # same qkv: K1 on the packed projection, K2 on the split heads
    tb, ts, tH, tD = (TRAIN_SHAPE[key] for key in "bsHD")
    qkv, dout = flash_case(torch, tb, ts, tH, tD, torch.bfloat16, seed=100)
    qb, kb, vb = (t.reshape(tb, ts, tH, tD).transpose(1, 2)
                  .reshape(tb * tH, ts, tD).contiguous()
                  for t in qkv.split(tH * tD, -1))
    dob = dout.reshape(tb, ts, tH, tD).transpose(1, 2).reshape(
        tb * tH, ts, tD).contiguous()
    o2, lse2 = fa.flash_fwd_kernel(qb, kb, vb, True, scale)
    d2 = (dob.float() * o2.float()).sum(-1)
    o1, lse1 = fap.flash_packed_fwd_kernel(qkv, tH, True, scale)
    d1 = fap._delta(o1, dout, tH)
    dqkv = torch.empty_like(qkv)
    bf16 = {
        "k2_fwd": device_ms(torch, [
            lambda: fa.flash_fwd_kernel(qb, kb, vb, True, scale)]),
        "k2_dkdv": device_ms(torch, [lambda: fa.flash_dkdv_kernel(
            qb, kb, vb, dob, lse2, d2, True, scale)]),
        "k2_dq": device_ms(torch, [lambda: fa.flash_dq_kernel(
            qb, kb, vb, dob, lse2, d2, True, scale)]),
        "k1_fwd": device_ms(torch, [
            lambda: fap.flash_packed_fwd_kernel(qkv, tH, True, scale)]),
        "k1_dkdv": device_ms(torch, [lambda: fap.flash_packed_dkdv_kernel(
            qkv, dout, lse1, d1, dqkv, tH, True, scale)]),
        "k1_dq": device_ms(torch, [lambda: fap.flash_packed_dq_kernel(
            qkv, dout, lse1, d1, dqkv, tH, True, scale)]),
    }
    same_out = float((o2.reshape(tb, tH, ts, tD).transpose(1, 2)
                      .reshape(tb, ts, tH * tD).float() - o1.float())
                     .abs().max())
    del qkv, dout, qb, kb, vb, dob, o1, o2, dqkv
    torch.cuda.empty_cache()
    wide = bhd_wide_times(torch, fa, F)
    for key in rows:
        rows[key]["wide_d256"] = {k: wide["timing"][key][k] for k in
                                  ("ms", "bound_ms", "bound_by",
                                   "library_ms")}
    tc16 = k2_tc16_times(torch, fa, F)
    emit({"phase": "flash_bhd", "shape": BHD_TRAIN_SHAPE, "dtype": "float32",
          "causal": True, "timing": timing, "backward_pair": pair_row,
          "library": {"call": "F.scaled_dot_product_attention(is_causal=True)"
                              " on (b, H, s, D) f32",
                      "backend": str(backend), "readings_vs_f64": lib_read},
          "plain_note": "dkdv and dq share one plain backward and one "
                        "library backward (each computes dq, dk, dv)",
          "bf16_beside_k1": {"shape": TRAIN_SHAPE, "ms": bf16,
                             "k1_vs_k2_out_max_abs": same_out},
          "wide": wide, "bf16_tc16": tc16})
    return rows, tc16


# K2's bf16 timing shapes up to 256 (flash_tc.cuh's instances at 64, 128
# and 256; causal, s = 1024): K1's timing shape at D = 64, and batches that
# keep b*H*s*D at a quarter or less of it at the wider heads
K2_TC16_SHAPES = {"d64": dict(b=32, s=1024, H=12, D=64),
                  "d128": dict(b=16, s=1024, H=8, D=128),
                  "d256": dict(b=8, s=1024, H=4, D=256)}
# K1's shapes of the --tc16-ab mode
K1_AB_SHAPES = {"d64": dict(b=32, s=1024, H=12, D=64),
                "d256": dict(b=8, s=1024, H=4, D=256)}


def k2_tc16_bounds(b, s, H, D):
    """K2's bf16 bounds at (b, s, H, D), causal: ``{kernel: flash_bound}``
    for the forward (2 products; q, k, v read, O and the LSE written),
    dK/dV (4; q, k, v, dO, LSE and Δ read, dK and dV written) and dQ (3;
    dQ written)."""
    e, n, rows = 2, b * H * s * D, b * H * s
    bwd_in = 4 * n * e + 2 * rows * 4
    return {"fwd": flash_bound(b, s, H, D, True, 2,
                               4 * n * e + rows * 4),
            "dkdv": flash_bound(b, s, H, D, True, 4, bwd_in + 2 * n * e),
            "dq": flash_bound(b, s, H, D, True, 3, bwd_in + n * e)}


def k2_tc16_case(torch, fa, sh, seed):
    """bf16 q, k, v, dO (b*H, s, D) at shape ``sh``, with the kernel
    forward's O and LSE and Δ."""
    import math
    b, s, H, D = (sh[k] for k in "bsHD")
    q, k, v, do = bhd_case(torch, b * H, s, s, D, torch.bfloat16, seed)
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    return q, k, v, do, o, lse, delta, scale


def k2_tc16_times(torch, fa, F):
    """K2's bf16 forward, dK/dV and dQ up to 256 (flash_tc.cuh, route
    ``tc16``) at each of ``K2_TC16_SHAPES``: each by graph replay beside its
    bounds, the plain version (bf16 in, f32 sums) and SDPA's bf16 forward
    and backward (default backend) on (b, H, s, D); the kernels' largest
    error against the plain versions on the same inputs.  At D = 64 the
    kernels' launches by route over three forward and backward passes
    through the public ``flash_attention``, counted from 0."""
    from paddle_hackathon_tpu_torch.incubate.nn import functional as tF
    out = {}
    for key, sh in K2_TC16_SHAPES.items():
        b, s, H, D = (sh[k] for k in "bsHD")
        q, k, v, do, o, lse, delta, sc = k2_tc16_case(torch, fa, sh, 300)
        dk, dv = fa.flash_dkdv_kernel(q, k, v, do, lse, delta, True, sc)
        dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, True, sc)
        po, plse = fa.flash_fwd_ref(q, k, v, True, sc)
        pdq, pdk, pdv = fa.flash_bwd_pair_ref(q, k, v, do, lse, delta, True,
                                              sc)
        torch.cuda.synchronize()

        def err(a, r):
            return float((a.float() - r.float()).abs().max())
        errs = {"fwd": err(o, po), "dkdv": max(err(dk, pdk), err(dv, pdv)),
                "dq": err(dq, pdq), "lse": err(lse, plse)}
        del po, plse, pdq, pdk, pdv, dk, dv, dq
        ms = {"fwd": device_ms(torch, [
                  lambda: fa.flash_fwd_kernel(q, k, v, True, sc)]),
              "dkdv": device_ms(torch, [lambda: fa.flash_dkdv_kernel(
                  q, k, v, do, lse, delta, True, sc)]),
              "dq": device_ms(torch, [lambda: fa.flash_dq_kernel(
                  q, k, v, do, lse, delta, True, sc)])}
        plain = {"fwd": device_ms(torch, [lambda: fa.flash_fwd_ref(
                     q, k, v, True, sc)], reps=2),
                 "pair": device_ms(torch, [lambda: fa.flash_bwd_pair_ref(
                     q, k, v, do, lse, delta, True, sc)], reps=2)}
        torch.cuda.empty_cache()
        qh, kh, vh, doh = (t.reshape(b, H, s, D) for t in (q, k, v, do))
        with torch.no_grad():
            lib_fwd = device_ms(torch, [lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)])
        xs = [t.detach().clone().requires_grad_(True) for t in (qh, kh, vh)]
        og = F.scaled_dot_product_attention(*xs, is_causal=True)
        lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
            og, xs, doh, retain_graph=True))
        del og, xs
        bounds = k2_tc16_bounds(b, s, H, D)
        rows = {}
        for kn in ("fwd", "dkdv", "dq"):
            b_ms, b_by, _, _ = bounds[kn]
            rows[kn] = {"max_abs_err": errs[kn], "ms": ms[kn],
                        "plain_ms": plain["fwd" if kn == "fwd" else "pair"],
                        "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_fwd if kn == "fwd" else lib_bwd}
        out[key] = {"shape": sh, "lse_max_abs_err": errs["lse"],
                    "pair_ms": ms["dkdv"] + ms["dq"],
                    "route": [fa.library_fwd_route(D, q.dtype),
                              fa.library_bwd_route(D, q.dtype)], **rows}
        if key == "d64":
            for counts in (fa.launches, fa.fwd_launches, fa.bwd_launches):
                for c in counts:
                    counts[c] = 0
            qs, ks, vs = (t.reshape(b, H, s, D).transpose(1, 2).detach()
                          .requires_grad_(True) for t in (q, k, v))
            dos = doh.transpose(1, 2)
            for _ in range(3):
                tF.flash_attention(qs, ks, vs, 0.0, True)[0].backward(dos)
            torch.cuda.synchronize()
            api = dict(fa.fwd_launches, **fa.bwd_launches)
            want = {c: 3 if c in ("fwd_tc16", "dkdv_tc16", "dq_tc16") else 0
                    for c in api}
            out[key].update(api_launches=api, api_launches_ok=api == want)
            del qs, ks, vs, dos
        del q, k, v, do, o, lse, delta, qh, kh, vh, doh
        torch.cuda.empty_cache()
    if not out["d64"]["api_launches_ok"]:
        raise AssertionError(f"flash_attention did not run on flash_tc.cuh's "
                             f"kernels alone: {out['d64']['api_launches']}")
    return out


BHD_WIDE_SHAPE = dict(b=8, s=1024, H=4, D=256)   # f32, the wide GPT's heads


def bhd_bounds(b, s, H, D, q, out, lse):
    """K2's f32 bounds: ({fwd, dkdv and dq as their 3xTF32 products, 3
    tf32 products each, on the tensor cores}, {each on the CUDA cores at
    67 TFLOP/s})."""
    e = 4
    io = 3 * q.numel() * e
    bwd_in = io + q.numel() * e + 2 * lse.numel() * 4
    work = {"fwd": (2, io + out.numel() * e + lse.numel() * 4),
            "dkdv": (4, bwd_in + 2 * q.numel() * e),
            "dq": (3, bwd_in + q.numel() * e)}
    f32 = {key: flash_bound(b, s, H, D, True, n, nb, H100_F32_FLOPS)
           for key, (n, nb) in work.items()}
    own = {}
    for key in ("fwd", "dkdv", "dq"):
        n, nb = work[key]
        own[key] = flash_bound(b, s, H, D, True, n, nb, H100_TF32_FLOPS / 3)
    return own, f32


def bhd_wide_times(torch, fa, F):
    """K2's three f32 kernels at ``BHD_WIDE_SHAPE`` (D = 256, causal) by
    graph replay, beside their f32 bounds, the plain versions and the
    library's f32 SDPA (default backend choice) forward and backward; the
    timed results held against the plain version in f64."""
    import math
    b, s, H, D = (BHD_WIDE_SHAPE[k] for k in "bsHD")
    bh, scale = b * H, 1.0 / math.sqrt(D)
    q, k, v, do = bhd_case(torch, bh, s, s, D, torch.float32, seed=201)
    out, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
    delta = (do * out).sum(-1)
    ms = {
        "fwd": device_ms(torch, [
            lambda: fa.flash_fwd_kernel(q, k, v, True, scale)]),
        "dkdv": device_ms(torch, [lambda: fa.flash_dkdv_kernel(
            q, k, v, do, lse, delta, True, scale)]),
        "dq": device_ms(torch, [lambda: fa.flash_dq_kernel(
            q, k, v, do, lse, delta, True, scale)]),
    }
    plain_fwd = device_ms(torch, [
        lambda: fa.flash_fwd_ref(q, k, v, True, scale)], reps=2)
    plain_bwd = device_ms(torch, [lambda: fa.flash_bwd_pair_ref(
        q, k, v, do, lse, delta, True, scale)], reps=2)
    dk, dv = fa.flash_dkdv_kernel(q, k, v, do, lse, delta, True, scale)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, True, scale)
    ref = bhd_plain(fa, q.double(), k.double(), v.double(), do.double(),
                    True, scale)
    readings = flash_readings(bhd_slices(out, lse, dq, dk, dv), ref,
                              live_floor=True)
    del ref, dk, dv, dq
    torch.cuda.empty_cache()
    if not flash_within(readings, FLASH_F32_TOL):
        raise AssertionError(f"bhd flash kernels disagree with their plain "
                             f"versions at {BHD_WIDE_SHAPE}: {readings}")
    qh, kh, vh, doh = (t.reshape(b, H, s, D) for t in (q, k, v, do))
    with torch.no_grad():
        lib_fwd = device_ms(torch, [lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)])
        lib_o = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        ref_o = fa.flash_fwd_ref(q.double(), k.double(), v.double(), True,
                                 scale)[0]
        lib_rel = float((lib_o.reshape(bh, s, D).double() - ref_o).norm()
                        / ref_o.norm())
        del lib_o, ref_o
    xs = [t.detach().clone().requires_grad_(True) for t in (qh, kh, vh)]
    og = F.scaled_dot_product_attention(*xs, is_causal=True)
    lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
        og, xs, doh, retain_graph=True))
    del og, xs
    bounds, f32_bounds = bhd_bounds(b, s, H, D, q, out, lse)
    plain = {"fwd": plain_fwd, "dkdv": plain_bwd, "dq": plain_bwd}
    lib = {"fwd": lib_fwd, "dkdv": lib_bwd, "dq": lib_bwd}
    timing = {}
    for key in ("fwd", "dkdv", "dq"):
        b_ms, b_by, flops, _ = bounds[key]
        timing[key] = {"ms": ms[key], "plain_ms": plain[key],
                       "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": lib[key],
                       "tflops": flops / ms[key] / 1e9,
                       "f32_cuda_core_bound_ms": f32_bounds[key][0]}
    timing["fwd"].update(out_rel_vs_f64=readings["out"]["rel"],
                         sdpa_out_rel_vs_f64=lib_rel)
    pair = ms["dkdv"] + ms["dq"]
    del q, k, v, do, out, lse, delta, qh, kh, vh, doh
    torch.cuda.empty_cache()
    return {"shape": BHD_WIDE_SHAPE, "dtype": "float32", "causal": True,
            "library": "F.scaled_dot_product_attention(is_causal=True), "
                       "default backend", "readings_vs_f64": readings,
            "timing": timing,
            "backward_pair": {
                "ms": pair, "plain_ms": plain_bwd, "sdpa_f32_backward_ms":
                lib_bwd, "bound_3xtf32_ms": bounds["dkdv"][0]
                + bounds["dq"][0], "bound_f32_cuda_cores_ms":
                f32_bounds["dkdv"][0] + f32_bounds["dq"][0]}}


def counting(module, names, calls):
    """Wrap ``module``'s functions ``names`` to count their calls in
    ``calls``; returns the originals, for :func:`restore`."""
    real = {n: getattr(module, n) for n in names}
    for n, fn in real.items():
        def run(*a, _n=n, _fn=fn, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)
        setattr(module, n, run)
    return real


def restore(module, real):
    for n, fn in real.items():
        setattr(module, n, fn)


def phase_train_f32(torch, fa, fap):
    """GPT-2-small f32 training through the port's default train step:
    attention dispatched as in JAX, so K2 at s=1024."""
    from torch.profiler import ProfilerActivity, profile

    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    b, s = BHD_TRAIN_SHAPE["b"], BHD_TRAIN_SHAPE["s"]
    arrays = random_weights(GPTForCausalLM(cfg, device="cpu"), seed=0)
    model, step, state = train_model(torch, cfg, arrays, param_dtype=None)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(DEV)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(DEV)
    plain_calls = {"flash_fwd_ref": 0, "flash_bwd_pair_ref": 0}
    real = counting(fa, plain_calls, plain_calls)
    try:
        losses = []
        for _ in range(2):                               # warm-up
            state, loss = step(state, ids, labels)
            losses.append(loss)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for counts in (fa.launches, fap.launches):
            for key in counts:
                counts[key] = 0
        steps = 10
        t0 = time.perf_counter()
        for _ in range(steps):
            state, loss = step(state, ids, labels)
            losses.append(loss)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, k1 = dict(fa.launches), dict(fap.launches)
        plain = dict(plain_calls)
    finally:
        restore(fa, real)
    peak = torch.cuda.max_memory_allocated()
    losses = [float(x) for x in losses]
    n_params = model.num_params()
    tps = steps * b * s / wall
    emit({"phase": "train_f32", "model": "gpt2-small-en f32", "batch": b,
          "seq": s, "steps": steps, "wall_s": wall,
          "ms_per_step": 1e3 * wall / steps, "tokens_per_s": tps,
          "mfu_f32": 6 * n_params * tps / H100_F32_FLOPS,
          "num_params": n_params, "peak_memory_gb": peak / 1e9,
          "losses": losses, "k2_launches": launches, "k1_launches": k1,
          "plain_k2_calls": plain})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite f32 training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"f32 loss did not fall on a repeated batch: "
                             f"{losses}")
    need = steps * cfg.num_layers
    if any(n != need for n in launches.values()):
        raise AssertionError(f"K2 launches {launches} != {need} each")
    if any(k1.values()) or any(plain.values()):
        raise AssertionError(f"f32 training ran K1 {k1} or the plain K2 "
                             f"versions {plain}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, ids, labels)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = profile_summary(torch, prof, wall)
    k2_us = sum(device_us(e) for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and "bhd_" in e.key)
    busy = summary["device_busy_s"] or float("nan")
    emit({"phase": "train_f32_profile", "steps": 1, **summary,
          "k2_device_ms": k2_us / 1e3,
          "k2_share_of_busy": k2_us / 1e6 / busy})
    del model, step, state, prof
    torch.cuda.empty_cache()

    # K2 (auto: flash at s=1024) against the plain composition, same init
    series, fwd_launches = {}, {}
    for use_flash in (None, False):
        name = "flash" if use_flash is None else "plain"
        c = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                       attention_dropout_prob=0.0,
                       use_flash_attention=use_flash)
        m, st_fn, st = train_model(torch, c, arrays, param_dtype=None)
        fa.launches["fwd"] = 0
        out = []
        for _ in range(3):
            st, loss = st_fn(st, ids[:4], labels[:4])
            out.append(float(loss))
        series[name], fwd_launches[name] = out, fa.launches["fwd"]
        del m, st_fn, st
        torch.cuda.empty_cache()
    rel = max(abs(x - y) / abs(y) for x, y in zip(series["flash"],
                                                  series["plain"]))
    emit({"phase": "train_f32_flash_vs_plain", "batch": 4, "seq": s,
          **series, "k2_fwd_launches": fwd_launches, "max_rel_diff": rel,
          "rtol": F32_FLASH_VS_PLAIN_RTOL})
    if fwd_launches != {"flash": 3 * cfg.num_layers, "plain": 0}:
        raise AssertionError(f"the flash series did not run K2 (or the "
                             f"plain one did): {fwd_launches}")
    if not rel <= F32_FLASH_VS_PLAIN_RTOL:
        raise AssertionError(f"f32 flash and plain loss series differ by "
                             f"{rel} > {F32_FLASH_VS_PLAIN_RTOL}: {series}")
    return launches


# ---------------------------------------------------------------------------
# Wide heads: a GPT at D = 256 through K1 (bf16) and K2 (f32)
# ---------------------------------------------------------------------------

WIDE_GPT = dict(hidden_size=1024, num_heads=4, num_layers=2)   # D = 256
WIDE512_GPT = dict(hidden_size=1024, num_heads=2, num_layers=2)   # D = 512


def phase_wide(torch, fa, fap, b=4, s=1024, steps=3, gpt=WIDE_GPT,
               name="wide"):
    """A dispatch and parity check at a wide head: a GPT of ``gpt``'s
    hidden size, heads and layers (vocab and positions of GPT-2-small;
    D = 256 for ``wide``, 512 for ``wide512``), Normal(0, 0.02) weights
    from a numpy seed, 3 train steps each way.  bf16 (``param_dtype=bf16``,
    ``use_flash_attention=True``) trains through K1; f32 (flash on auto)
    through SDPA and K2.  Gates: the flash series' kernel launches exactly
    3 x 2 each, and by kernel (``fwd_launches``, ``bwd_launches``): 3 x 2
    of the forward its width runs (K1 ``fwd_tma`` at 256, ``wide_fwd_tc``
    past it; K2 f32 ``fwd_tc`` at 256, ``wide_fwd_tc`` past it) and of
    its dK/dV and dQ (K1 ``*_tma`` at 256, the tensor-core ``*_wide_tc``
    past it; K2 f32 ``*_tc`` at 256, the 3xTF32 ``*_wide_tc_f32`` past it),
    0 of every other; the other family's 0, the plain versions called 0
    times; the flash and plain-composition loss series within the bf16 /
    f32 limits.  Returns each family's launches by kernel."""
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    base = dict(gpt, hidden_dropout_prob=0.0, attention_dropout_prob=0.0)
    arrays = random_weights(GPTForCausalLM(gpt_config("gpt2-small-en",
                                                      **base),
                                           device="cpu"), seed=2)
    rng = np.random.RandomState(2)
    vocab = gpt_config("gpt2-small-en").vocab_size
    ids = torch.from_numpy(rng.randint(0, vocab, (b, s))).to(DEV)
    labels = torch.from_numpy(rng.randint(0, vocab, (b, s))).to(DEV)
    report = {}
    runs = (("bf16", "bfloat16", True, fap, fa, FLASH_VS_PLAIN_RTOL),
            ("f32", None, None, fa, fap, F32_FLASH_VS_PLAIN_RTOL))
    D = gpt["hidden_size"] // gpt["num_heads"]
    fwd_kernel = {fap: fap.fwd_kernel_of(D),
                  fa: fa.fwd_route(D, torch.float32)}
    bwd_kernel = {fap: fap.bwd_kernel_of(D),
                  fa: fa.bwd_route(D, torch.float32)}
    plain_names = {fap: ("flash_packed_fwd_ref", "flash_packed_bwd_ref"),
                   fa: ("flash_fwd_ref", "flash_bwd_pair_ref")}
    for tag, param_dtype, flash, used, other, rtol in runs:
        series = {}
        for use_flash in (flash, False):
            cfg = gpt_config("gpt2-small-en", use_flash_attention=use_flash,
                             **base)
            model, step, state = train_model(torch, cfg, arrays,
                                             param_dtype=param_dtype)
            calls = {n: 0 for m in (fa, fap) for n in plain_names[m]}
            reals = [(m, counting(m, plain_names[m], calls))
                     for m in (fa, fap)]
            for counts in (fa.launches, fap.launches, fa.fwd_launches,
                           fap.fwd_launches, fa.bwd_launches,
                           fap.bwd_launches):
                for key in counts:
                    counts[key] = 0
            try:
                losses = []
                for _ in range(steps):
                    state, loss = step(state, ids, labels)
                    losses.append(float(loss))
                torch.cuda.synchronize()
            finally:
                for m, real in reals:
                    restore(m, real)
            run = "plain" if use_flash is False else "flash"
            series[run] = {"losses": losses,
                            "launches": dict(used.launches),
                            "fwd_launches": dict(used.fwd_launches),
                            "bwd_launches": dict(used.bwd_launches),
                            "other_launches": dict(other.launches),
                            "other_fwd_launches": dict(other.fwd_launches),
                            "other_bwd_launches": dict(other.bwd_launches),
                            "plain_calls": calls}
            del model, step, state
            torch.cuda.empty_cache()
        rel = max(abs(x - y) / abs(y) for x, y in
                  zip(series["flash"]["losses"], series["plain"]["losses"]))
        report[tag] = dict(series, max_rel_diff=rel, rtol=rtol)
        need = steps * gpt["num_layers"]
        f = series["flash"]
        want = {key: need if key == fwd_kernel[used] else 0
                for key in used.fwd_launches}
        want_bwd = {key: need if key.split("_", 1)[1] == bwd_kernel[used]
                    else 0 for key in used.bwd_launches}
        if (any(n != need for n in f["launches"].values())
                or f["fwd_launches"] != want
                or f["bwd_launches"] != want_bwd
                or any(f["other_launches"].values())
                or any(f["other_fwd_launches"].values())
                or any(f["other_bwd_launches"].values())
                or any(f["plain_calls"].values())
                or any(series["plain"]["launches"].values())
                or any(series["plain"]["fwd_launches"].values())
                or any(series["plain"]["bwd_launches"].values())):
            raise AssertionError(f"{name} {tag}: the flash series did not "
                                 f"run its kernels exactly {need} times each "
                                 f"(or ran the other family, or a plain "
                                 f"version): {series}")
        if not all(np.isfinite(f["losses"])) or not rel <= rtol:
            raise AssertionError(f"{name} {tag}: flash and plain loss "
                                 f"series differ by {rel} > {rtol}: "
                                 f"{series}")
    emit({"phase": name, "model": gpt, "head_dim": D, "batch": b, "seq": s,
          "steps": steps, "fwd_kernel": {"bf16": fwd_kernel[fap],
                                         "f32": fwd_kernel[fa]},
          "bwd_kernel": {"bf16": bwd_kernel[fap], "f32": bwd_kernel[fa]},
          **report})
    return {tag: dict(report[tag]["flash"]["fwd_launches"],
                      **report[tag]["flash"]["bwd_launches"])
            for tag in report}


WIDE512_SHAPE = dict(b=2, s=1024, H=2, D=512)   # the wide512 GPT's heads


def timed_fwd_check(torch, ref_fn, inputs, got, ref_dtype, tol, causal,
                    scale):
    """A timed forward's O and LSE (``got``) against the plain forward
    ``ref_fn(*inputs, causal, scale)`` run in ``ref_dtype``: relative L2,
    worst row and LSE readings within ``tol``, and the largest absolute
    error of O."""
    ref_o, ref_l = ref_fn(*(t.to(ref_dtype) for t in inputs), causal, scale)
    o, lse = got
    err = o.to(ref_dtype) - ref_o.reshape(o.shape)
    rows = ref_o.reshape(o.shape).norm(dim=-1)
    r = {"rel": float(err.norm() / ref_o.norm()),
         "row": float((err.norm(dim=-1) / rows.clamp_min(rows.median()))
                      .max()),
         "lse": float((lse.to(ref_dtype) - ref_l.reshape(lse.shape)).abs()
                      .max()),
         "max_abs_err": float(err.abs().max())}
    r["ok"] = (r["rel"] <= tol["rel"] and r["row"] <= tol["row"]
               and r["lse"] <= tol["lse"])
    return r


def timed_pair_check(torch, fa, q, k, v, do, lse, delta, got, scale):
    """A timed pair's dq, dk, dv (``got``) against the plain pair on the
    same inputs: bf16/f16 against it in f32, relative L2 and worst row
    within ``FLASH_TOL``; f32 against it in f64, relative L2 within
    ``FLASH_F32_PAIR_REL`` and worst row within ``FLASH_F32_TOL``; and the
    largest absolute error."""
    f32 = q.dtype == torch.float32
    wide = torch.float64 if f32 else torch.float32
    rel_tol = FLASH_F32_PAIR_REL if f32 else FLASH_TOL["rel"]
    row_tol = (FLASH_F32_TOL if f32 else FLASH_TOL)["row"]
    ref = fa.flash_bwd_pair_ref(*(t.to(wide) for t in (q, k, v, do, lse,
                                                       delta)),
                                True, scale)
    r = {"ok": True, "max_abs_err": 0.0}
    for name, g, want in zip(("dq", "dk", "dv"), got, ref):
        err = g.to(wide) - want
        rows = want.norm(dim=-1)
        rel = float(err.norm() / want.norm())
        row = float((err.norm(dim=-1) / rows.clamp_min(
            rows[rows > 0].median())).max())
        r[f"{name}_rel"], r[f"{name}_row"] = rel, row
        r["max_abs_err"] = max(r["max_abs_err"], float(err.abs().max()))
        r["ok"] = r["ok"] and rel <= rel_tol and row <= row_tol
    return r


def wide512_times(torch, fa, fap, pa):
    """The kernels at the wide512 GPT's attention (D = 512, b=2, H=2,
    s=1024, causal) by graph replay: K2 in f32 (all three on the tensor
    cores, 3xTF32) and K1 in bf16 (all three column-chunked on the tensor
    cores) beside their plain versions, SDPA (default backend) and two
    bounds each (the tensor cores at the inputs' type, and the CUDA
    cores' f32 rate); each timed forward's O and LSE held against the
    plain version (f32 against f64 at ``FLASH_F32_TOL``, bf16 against f32
    at ``FLASH_TOL``), and K2's f32 dK/dV + dQ against the plain pair in
    f64 (``timed_pair_check``: ``FLASH_F32_PAIR_REL``).  Then K2's
    bf16 forward and dK/dV + dQ pair at the same shape (the pair held
    against the plain pair in f32), with the pair's launches by kernel
    over three forward and backward passes through the public
    ``incubate.nn.functional.flash_attention`` (counts set to 0 just
    before), and K2's f32 forward at D = 514 (rows TMA cannot address:
    zero-padded to 516 onto the tensor-core forward; the pad copies timed
    on their own) beside the same yardsticks.  K3 at D = 512 (16 slots,
    12 heads, 8 pages of 16) at width 1 (the split decode kernel, its row
    in column slices) in bf16, f16 and f32, and a bf16 chunk of 32 (paged
    TMA + wgmma), each held against its plain version in f32 (2e-2, f32
    2e-5), beside the plain version's time, SDPA on the gathered K/V in
    the case's type and the bound."""
    import math

    import torch.nn.functional as F
    b, s, H, D = (WIDE512_SHAPE[k] for k in "bsHD")
    scale = 1.0 / math.sqrt(D)
    out = {}
    q, k, v, do = bhd_case(torch, b * H, s, s, D, torch.float32, seed=512)
    o, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
    delta = (do * o).sum(-1)
    ms = {"fwd": device_ms(torch, [
              lambda: fa.flash_fwd_kernel(q, k, v, True, scale)]),
          "dkdv": device_ms(torch, [lambda: fa.flash_dkdv_kernel(
              q, k, v, do, lse, delta, True, scale)]),
          "dq": device_ms(torch, [lambda: fa.flash_dq_kernel(
              q, k, v, do, lse, delta, True, scale)])}
    plain = {"fwd": device_ms(torch, [lambda: fa.flash_fwd_ref(
                 q, k, v, True, scale)], reps=2),
             "bwd": device_ms(torch, [lambda: fa.flash_bwd_pair_ref(
                 q, k, v, do, lse, delta, True, scale)], reps=2)}
    qh, kh, vh, doh = (t.reshape(b, H, s, D) for t in (q, k, v, do))
    with torch.no_grad():
        lib_fwd = device_ms(torch, [lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)])
    xs = [t.detach().clone().requires_grad_(True) for t in (qh, kh, vh)]
    og = F.scaled_dot_product_attention(*xs, is_causal=True)
    lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
        og, xs, doh, retain_graph=True))
    tcb, f32b = bhd_bounds(b, s, H, D, q, o, lse)
    out["k2_f32"] = {key: {
        "ms": ms[key], "plain_ms": plain["fwd" if key == "fwd" else "bwd"],
        "library_ms": lib_fwd if key == "fwd" else lib_bwd,
        "bound_ms": tcb[key][0] if key != "fwd" else
        flash_bound(b, s, H, D, True, 2, f32b["fwd"][3],
                    H100_TF32_FLOPS / 3)[0],
        "bound_by": "operations",
        "f32_cuda_core_bound_ms": f32b[key][0]} for key in ms}
    out["k2_f32"]["fwd"].update(timed_fwd_check(
        torch, fa.flash_fwd_ref, (q, k, v), (o, lse), torch.float64,
        FLASH_F32_TOL, True, scale), kernel=fa.library_fwd_route(
            D, torch.float32))
    # the timed pair's own results against the plain pair in f64
    dk, dv = fa.flash_dkdv_kernel(q, k, v, do, lse, delta, True, scale)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, True, scale)
    pair = timed_pair_check(torch, fa, q, k, v, do, lse, delta, (dq, dk, dv),
                            scale)
    for key in ("dkdv", "dq"):
        out["k2_f32"][key].update(pair, route=fa.library_bwd_route(
            D, torch.float32))
    del q, k, v, do, o, lse, delta, qh, kh, vh, doh, xs, og, dq, dk, dv
    torch.cuda.empty_cache()
    # K2's bf16 forward and pair past 256 (not on a GPT path: bf16 GPTs
    # take K1) and its f32 forward at D = 514 (padded to 516), each at the
    # same b, H and s
    for tag, dt, d in (("k2_bf16", torch.bfloat16, D),
                       ("k2_f32_d514", torch.float32, 514)):
        sc = 1.0 / math.sqrt(d)
        q, k, v, do = bhd_case(torch, b * H, s, s, d, dt, seed=515)
        o, lse = fa.flash_fwd_kernel(q, k, v, True, sc)
        qh, kh, vh = (t.reshape(b, H, s, d) for t in (q, k, v))
        e = q.element_size()
        nb = 4 * q.numel() * e + lse.numel() * 4
        peak = H100_BF16_FLOPS if e == 2 else H100_TF32_FLOPS / 3
        with torch.no_grad():
            lib = device_ms(torch, [lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True)])
        out[tag] = {"fwd": dict(
            ms=device_ms(torch, [
                lambda: fa.flash_fwd_kernel(q, k, v, True, sc)]),
            plain_ms=device_ms(torch, [lambda: fa.flash_fwd_ref(
                q, k, v, True, sc)], reps=2),
            library_ms=lib,
            bound_ms=flash_bound(b, s, H, d, True, 2, nb, peak)[0],
            bound_by=flash_bound(b, s, H, d, True, 2, nb, peak)[1],
            f32_cuda_core_bound_ms=flash_bound(b, s, H, d, True, 2, nb,
                                               H100_F32_FLOPS)[0],
            kernel=fa.library_fwd_route(d, dt),
            **timed_fwd_check(torch, fa.flash_fwd_ref, (q, k, v), (o, lse),
                              torch.float64 if e == 4 else torch.float32,
                              FLASH_F32_TOL if e == 4 else FLASH_TOL, True,
                              sc))}
        width = fa.padded_width(d, dt)
        if width != d:
            out[tag]["fwd"].update(padded_to=width, pad_ms=device_ms(
                torch, [lambda: [fa._pad(t, width) for t in (q, k, v)]]))
        if e == 2:
            out[tag].update(k2_bf16_pair(torch, fa, F, q, k, v, do, o, lse,
                                         sc))
        del q, k, v, do, o, lse, qh, kh, vh
        torch.cuda.empty_cache()

    qkv, dout = flash_case(torch, b, s, H, D, torch.bfloat16, seed=513)
    o, lse = fap.flash_packed_fwd_kernel(qkv, H, True, scale)
    delta = fap._delta(o, dout, H)
    dqkv = torch.empty_like(qkv)
    ms = {"fwd": device_ms(torch, [
              lambda: fap.flash_packed_fwd_kernel(qkv, H, True, scale)]),
          "dkdv": device_ms(torch, [lambda: fap.flash_packed_dkdv_kernel(
              qkv, dout, lse, delta, dqkv, H, True, scale)]),
          "dq": device_ms(torch, [lambda: fap.flash_packed_dq_kernel(
              qkv, dout, lse, delta, dqkv, H, True, scale)])}
    plain = {"fwd": device_ms(torch, [lambda: fap.flash_packed_fwd_ref(
                 qkv, H, True, scale)], reps=2),
             "bwd": device_ms(torch, [lambda: fap.flash_packed_bwd_ref(
                 qkv, o, lse, dout, H, True, scale)], reps=2)}
    qh, kh, vh = (t.reshape(b, s, H, D).transpose(1, 2).contiguous()
                  .requires_grad_(True) for t in qkv.split(H * D, -1))
    doh = dout.reshape(b, s, H, D).transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = device_ms(torch, [lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)])
    og = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
        og, (qh, kh, vh), doh, retain_graph=True))
    e = 2
    io = qkv.numel() * e + lse.numel() * 4
    bwd_in = io + dout.numel() * e + delta.numel() * 4
    work = {"fwd": (2, io + o.numel() * e),
            "dkdv": (4, bwd_in + 2 * o.numel() * e),
            "dq": (3, bwd_in + o.numel() * e)}
    k1_check = timed_fwd_check(
        torch, lambda x, c, sc: fap.flash_packed_fwd_ref(x, H, c, sc),
        (qkv,), (o, lse), torch.float32, FLASH_TOL, True, scale)
    out["k1_bf16"] = {}
    for key, (n, nb) in work.items():
        b_ms, b_by, _, _ = flash_bound(b, s, H, D, True, n, nb)
        out["k1_bf16"][key] = {
            "ms": ms[key], "plain_ms": plain["fwd" if key == "fwd" else
                                             "bwd"],
            "library_ms": lib_fwd if key == "fwd" else lib_bwd,
            "bound_ms": b_ms, "bound_by": b_by,
            "f32_cuda_core_bound_ms": flash_bound(b, s, H, D, True, n, nb,
                                                  H100_F32_FLOPS)[0]}
    out["k1_bf16"]["fwd"].update(k1_check, kernel=fap.fwd_kernel_of(D))
    # the timed pair's dqkv against the plain backward in f32
    r = flash_readings(flash_slices(o, lse, dqkv, H),
                       flash_plain(fap, qkv.float(), dout.float(), H, True,
                                   scale))
    for key, slices in (("dkdv", ("dk", "dv")), ("dq", ("dq",))):
        out["k1_bf16"][key].update(
            kernel=f"{key}_{fap.bwd_kernel_of(D)}",
            max_abs_err=max(r[sl]["max_abs"] for sl in slices),
            ok=all(r[sl]["rel"] <= FLASH_TOL["rel"]
                   and r[sl]["row"] <= FLASH_TOL["row"] for sl in slices),
            **{f"{sl}_{m}": r[sl][m] for sl in slices for m in ("rel",
                                                               "row")})
    del qkv, dout, o, lse, delta, dqkv, qh, kh, vh, doh, og
    torch.cuda.empty_cache()

    # K3: decode (the split kernel in column slices) in each type, and a
    # bf16 chunk of 32 (paged TMA + wgmma); SDPA in the case's type, TF32
    # off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for tag, dt, width, tol in (("k3_bf16", torch.bfloat16, 1, 2e-2),
                                ("k3_bf16", torch.bfloat16, 32, 2e-2),
                                ("k3_f16", torch.float16, 1, 2e-2),
                                ("k3_f32", torch.float32, 1, 2e-5)):
        case = kernel_case(torch, dt, width, seed=514 + width, D=D, maxp=8)
        cs = copies(case)
        # f16 cannot hold the plain version's -1e30 mask: its plain version
        # runs on the inputs in f32
        pcs = [f32_case(c) for c in cs] if dt == torch.float16 else cs
        libs = [gathered(torch, c) for c in cs]
        b_ms, b_by = k3_bound(case)
        # the timed kernel's result against the plain version in f32, at
        # the paged checks' limits
        ref32 = pa.paged_attention_ref(**f32_case(case))
        err = (pa.paged_attention_kernel(**case).float() - ref32).abs()
        out.setdefault(tag, {})[f"w{width}"] = {
            "route": pa.tile_route(width, D, dt, case["k_pool"].shape[1]),
            "max_abs_err": float(err.max()), "tol": tol,
            "ok": bool((err <= tol + tol * ref32.abs()).all()),
            "ms": device_ms(torch, [lambda c=c: pa.paged_attention_kernel(**c)
                                    for c in cs]),
            "plain_ms": device_ms(torch, [
                lambda c=c: pa.paged_attention_ref(**c) for c in pcs],
                reps=2),
            "library_ms": device_ms(torch, [
                lambda a=a: F.scaled_dot_product_attention(
                    a[0], a[1], a[2], attn_mask=a[3]) for a in libs]),
            "bound_ms": b_ms, "bound_by": b_by}
        del cs, pcs, libs, case, ref32, err
        torch.cuda.empty_cache()
    bad = [f"{key}_fwd" for key in ("k2_f32", "k2_bf16", "k2_f32_d514",
                                     "k1_bf16") if not out[key]["fwd"]["ok"]]
    bad += [f"{tag}_{key}" for tag in ("k1_bf16", "k2_bf16", "k2_f32")
            for key in ("dkdv", "dq") if not out[tag][key]["ok"]]
    bad += [f"{tag}_{w}" for tag in ("k3_bf16", "k3_f16", "k3_f32")
            for w, row in out[tag].items() if not row["ok"]]
    if not out["k2_bf16"]["api_launches_ok"]:
        bad.append("k2_bf16_api_launches")
    if bad:
        raise AssertionError(f"the timed forwards disagree with their plain "
                             f"versions: {bad}: {out}")
    return {"shape": WIDE512_SHAPE, "k3_geometry": "16 slots, 12 heads, "
            "D=512, pages of 16, 8 a slot", **out}


def k2_bf16_pair(torch, fa, F, q, k, v, do, o, lse, sc):
    """K2's bf16 dK/dV and dQ past 256 (``dkdv_tc`` / ``dq_tc``) on (b*H,
    s, D) inputs with their forward's O and LSE: each by graph replay
    beside its bounds, the plain pair and SDPA's backward, the pair held
    against the plain pair in f32; then its launches by kernel over three
    forward and backward passes through ``flash_attention``."""
    from paddle_hackathon_tpu_torch.incubate.nn import functional as tF
    bh, s, d = q.shape
    b, H = WIDE512_SHAPE["b"], WIDE512_SHAPE["H"]
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = fa.flash_dkdv_kernel(q, k, v, do, lse, delta, True, sc)
    dq = fa.flash_dq_kernel(q, k, v, do, lse, delta, True, sc)
    check = timed_pair_check(torch, fa, q, k, v, do, lse, delta,
                             (dq, dk, dv), sc)
    ms = {"dkdv": device_ms(torch, [lambda: fa.flash_dkdv_kernel(
              q, k, v, do, lse, delta, True, sc)]),
          "dq": device_ms(torch, [lambda: fa.flash_dq_kernel(
              q, k, v, do, lse, delta, True, sc)])}
    plain = device_ms(torch, [lambda: fa.flash_bwd_pair_ref(
        q, k, v, do, lse, delta, True, sc)], reps=2)
    xs = [t.reshape(b, H, s, d).detach().clone().requires_grad_(True)
          for t in (q, k, v)]
    og = F.scaled_dot_product_attention(*xs, is_causal=True)
    lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
        og, xs, do.reshape(b, H, s, d), retain_graph=True))
    e = 2
    bwd_in = 4 * q.numel() * e + 2 * lse.numel() * 4
    rows = {}
    for key, n, nout in (("dkdv", 4, 2), ("dq", 3, 1)):
        nb = bwd_in + nout * q.numel() * e
        b_ms, b_by, _, _ = flash_bound(b, s, H, d, True, n, nb)
        rows[key] = {"ms": ms[key], "plain_ms": plain,
                     "library_ms": lib_bwd, "bound_ms": b_ms,
                     "bound_by": b_by,
                     "f32_cuda_core_bound_ms": flash_bound(
                         b, s, H, d, True, n, nb, H100_F32_FLOPS)[0],
                     "route": fa.library_bwd_route(d, q.dtype), **check}
    del og, xs
    # the pair on a user's path: the public API, counts from 0
    for counts in (fa.launches, fa.fwd_launches, fa.bwd_launches):
        for key in counts:
            counts[key] = 0
    qs, ks, vs = (t.reshape(b, H, s, d).transpose(1, 2).detach()
                  .requires_grad_(True) for t in (q, k, v))
    dos = do.reshape(b, H, s, d).transpose(1, 2)
    for _ in range(3):
        tF.flash_attention(qs, ks, vs, 0.0, True)[0].backward(dos)
    torch.cuda.synchronize()
    api = dict(fa.bwd_launches, **fa.fwd_launches)
    want = {key: 3 if key in ("dkdv_wide_tc", "dq_wide_tc", "wide_fwd_tc")
            else 0 for key in api}
    return dict(rows, api_launches=api, api_launches_ok=api == want)


def phase_dispatch_repairs(torch, fap, pa, qm, wo):
    """The dispatchers hand the kernels what they take, on the card: K1
    through ``flash_attention_qkv_packed`` on a strided qkv (the first 3 H
    D columns of a wider projection), K3 through ``paged_attention`` with
    an int64 page table and lengths, K4 through ``quant_matmul`` with a
    transposed weight view and a bf16 scale.  Each launches its kernel
    (counted) and equals the call on the normalised arguments bit for
    bit."""
    from paddle_hackathon_tpu_torch.incubate.nn.functional import \
        flash_attention_qkv_packed
    rows = {}
    # K1: forward and backward on the strided view
    b, s, H, D = 2, 256, 4, 64
    gen = torch.Generator(device=DEV).manual_seed(7)
    wide = (torch.randn(b, s, 3 * H * D + 64, generator=gen, device=DEV)
            * 0.5).to(torch.bfloat16)
    cot = torch.randn(b, s, H * D, generator=gen, device=DEV).to(
        torch.bfloat16)
    x = wide.clone().requires_grad_(True)
    view = x[..., :3 * H * D]
    ref_x = wide[..., :3 * H * D].contiguous().requires_grad_(True)
    before = dict(fap.launches)
    got = flash_attention_qkv_packed(view, H)
    got.backward(cot)
    ref = flash_attention_qkv_packed(ref_x, H)
    ref.backward(cot)
    torch.cuda.synchronize()
    rows["k1_strided_qkv"] = {
        "strided": not view.is_contiguous(),
        "launches": {k: fap.launches[k] - before[k] for k in before},
        "equal": torch.equal(got, ref) and torch.equal(
            x.grad[..., :3 * H * D], ref_x.grad)}
    # K3: an int64 table and lengths
    case = kernel_case(torch, torch.bfloat16, 1, seed=70)
    before = dict(pa.launches)
    got = pa.paged_attention(case["q"], case["k_pool"], case["v_pool"],
                             case["page_table"].long(),
                             case["lengths"].long())
    ref = pa.paged_attention(**case)
    torch.cuda.synchronize()
    rows["k3_int64_table"] = {
        "launches": {k: pa.launches[k] - before[k] for k in before},
        "equal": torch.equal(got, ref)}
    # K4: a transposed weight view and a bf16 scale
    c = quant_case(torch, wo, 8, 768, 768, "int8", torch.bfloat16, seed=71)
    w_t = c["w_q"].t().contiguous().t()
    scale = c["scale"].to(torch.bfloat16)
    before = qm.launches
    got = qm.quant_matmul(c["x2d"], w_t, scale)
    ref = qm.quant_matmul(c["x2d"], c["w_q"], scale.float())
    torch.cuda.synchronize()
    rows["k4_strided_weight_bf16_scale"] = {
        "strided": not w_t.is_contiguous(),
        "launches": qm.launches - before, "equal": torch.equal(got, ref)}
    emit({"phase": "dispatch_repairs", **rows})
    ok = (rows["k1_strided_qkv"]["strided"]
          and rows["k1_strided_qkv"]["launches"] == {"fwd": 2, "dkdv": 2,
                                                     "dq": 2}
          and sum(rows["k3_int64_table"]["launches"].values()) == 2
          and rows["k4_strided_weight_bf16_scale"]["strided"]
          and rows["k4_strided_weight_bf16_scale"]["launches"] == 2
          and all(r["equal"] for r in rows.values()))
    if not ok:
        raise AssertionError(f"a dispatcher did not hand its kernel what it "
                             f"takes: {rows}")


def random_weights(model, seed):
    """Normal(0, 0.02) matrices, zero biases, unit layer-norm scales, as the
    JAX model initialises them, keyed by the JAX state-dict names (GPT's
    layer norms are ``ln_*``, BERT's ``ln_*`` and ``layer_norm``; BERT's
    ``decoder_bias`` is a bias)."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("bias"):
            arrays[name] = np.zeros(shape, np.float32)
        elif ".ln_" in name or ".layer_norm." in name:
            arrays[name] = np.ones(shape, np.float32)
        else:
            arrays[name] = (rng.standard_normal(shape, np.float32)
                            * np.float32(0.02))
    return arrays


def margin_at(torch, model, prefix, tok_a, tok_b):
    with torch.inference_mode():
        ids = torch.tensor(np.asarray(prefix)[None], device=DEV)
        logits = model(ids)[0, -1].float()
    return float((logits[tok_a] - logits[tok_b]).abs())


def phase_serving(torch, pa):
    from paddle_hackathon_tpu_torch.inference import ServingEngine
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.utils import load_jax_state

    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device=DEV, dtype="bfloat16")
    arrays = random_weights(model, seed=0)
    load_jax_state(model, arrays)
    eng_kw = dict(max_slots=16, max_len=512, page_size=16, num_pages=257,
                  chunk=32, decode_window=32)
    eng = ServingEngine(model, auto_run=False, cache_mode="paged", **eng_kw)
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, 64).astype(np.int32)
               for _ in range(16)]
    warm = eng.submit(rng.randint(0, cfg.vocab_size, 64), 2)
    eng.run_until_idle()
    assert warm.done
    eng.drop_prefix_cache()
    ticks0 = dict(eng.stats)

    runs = []
    plain = {"paged_attention_ref": 0}
    real = counting(pa, plain, plain)
    for _ in range(3):   # host-bound: repeat to show the spread
        ticks0 = dict(eng.stats)
        for counts in (pa.launches, pa.kernel_launches):
            for k in counts:
                counts[k] = 0
        plain["paged_attention_ref"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, 128) for p in prompts]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pa.launches)
        by_kernel = dict(pa.kernel_launches)
        decode_ticks = eng.stats["decode_ticks"] - ticks0["decode_ticks"]
        chunk_ticks = eng.stats["chunk_ticks"] - ticks0["chunk_ticks"]
        for r in reqs:
            toks = np.asarray(r.tokens)
            assert r.done and len(toks) == 128, (r.done, len(toks))
            assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        # every decode step runs the split decode kernel and every chunk
        # tick the tile kernels, once per layer; the plain version never
        need = decode_ticks * eng._decode_window * cfg.num_layers
        assert decode_ticks > 0 and launches["paged_decode"] == need, (
            launches, need)
        assert launches["paged_attention"] == \
            chunk_ticks * cfg.num_layers, launches
        # by kernel: the chunks on paged TMA + wgmma, every other K3
        # kernel never
        engine_routes_ok({"kernel_launches": by_kernel,
                          "plain_calls": plain["paged_attention_ref"],
                          "chunk_ticks": chunk_ticks,
                          "decode_ticks": decode_ticks}, cfg.num_layers,
                         eng._decode_window, "tiles_tc", "bf16 serving")
        eng.drop_prefix_cache()
        assert eng.kv_pages_in_use == 0, eng.kv_pages_in_use
        ttft = sorted(r.ttft_s for r in reqs)
        runs.append({"wall_s": wall, "tokens_per_s": 16 * 128 / wall,
                     "ttft_p50_s": ttft[len(ttft) // 2],
                     "ttft_max_s": ttft[-1], "decode_ticks": decode_ticks,
                     "chunk_ticks": chunk_ticks, "kernel_launches": launches,
                     "launches_by_kernel": by_kernel,
                     "plain_calls": plain["paged_attention_ref"]})
    restore(pa, real)
    med = sorted(runs, key=lambda r: r["wall_s"])[1]
    emit({"phase": "serving", "model": "gpt2-small-en bf16",
          "requests": 16, "prompt": 64, "new_tokens": 128,
          "median": med, "runs": runs, "kv_pages_in_use": 0})
    launches = runs[0]["kernel_launches"]

    # f32: the paged engine (kernel) against the dense engine (the plain
    # static-cache path) on the same weights; the paged run's chunks on the
    # f32 prefill kernel (paged TMA + 3xTF32 wgmma), its decode steps on
    # the split kernel, every other K3 kernel and the plain version never
    m32 = GPTForCausalLM(cfg, device=DEV)
    load_jax_state(m32, arrays)
    outs, f32_stats = {}, {}
    for mode in ("paged", "dense"):
        e = ServingEngine(m32, auto_run=False, cache_mode=mode, **eng_kw)
        f32_stats[mode] = counted_run(
            torch, pa, e, lambda e=e: [e.submit(p, 32) for p in prompts[:4]])
        outs[mode] = [r.result() for r in f32_stats[mode].pop("requests")]
        if mode == "paged":
            engine_routes_ok(f32_stats[mode], cfg.num_layers,
                             e._decode_window, "tiles_tf32", "f32 serving")
        del e
    if any(f32_stats["dense"]["kernel_launches"].values()):
        raise AssertionError(f"the dense engine launched K3: {f32_stats}")
    exact, margins = 0, []
    for p, a, b in zip(prompts[:4], outs["paged"], outs["dense"]):
        diff = np.nonzero(a != b)[0]
        if not len(diff):
            exact += 1
            continue
        k = int(diff[0])
        m = margin_at(torch, m32, b[:k], int(a[k]), int(b[k]))
        margins.append({"position": k - len(p), "margin": m})
        if m > 1e-3:
            raise AssertionError(f"paged f32 run diverges from dense at "
                                 f"new token {k - len(p)} with logit margin "
                                 f"{m} > 1e-3")
    emit({"phase": "f32_cross_check", "requests": 4, "new_tokens": 32,
          "token_exact": exact, "divergences": margins, **f32_stats})
    return (eng, prompts, dict(launches, **runs[0]["launches_by_kernel"]),
            f32_stats["paged"]["kernel_launches"])


def counted_run(torch, pa, eng, submit):
    """Run ``submit()``'s requests to the end on ``eng`` with K3's counts
    (per entry point and per kernel) and the plain version's calls set to
    0 just before and read just after, beside the engine's ticks."""
    plain = {"paged_attention_ref": 0}
    ticks0 = dict(eng.stats)
    real = counting(pa, plain, plain)
    for counts in (pa.launches, pa.kernel_launches):
        for k in counts:
            counts[k] = 0
    try:
        reqs = submit()
        eng.run_until_idle()
        torch.cuda.synchronize()
    finally:
        restore(pa, real)
    return {"requests": reqs, "kernel_launches": dict(pa.kernel_launches),
            "plain_calls": plain["paged_attention_ref"],
            "chunk_ticks": eng.stats["chunk_ticks"] - ticks0["chunk_ticks"],
            "decode_ticks": eng.stats["decode_ticks"]
            - ticks0["decode_ticks"]}


def engine_routes_ok(st, layers, window, chunk_kernel, what):
    """A paged engine run's K3 launches: every chunk tick ran
    ``chunk_kernel`` and every decode step the split kernel, once a layer
    each; every other K3 kernel and the plain version never."""
    got = st["kernel_launches"]
    want = {k: 0 for k in got}
    want[chunk_kernel] = st["chunk_ticks"] * layers
    want["split"] = st["decode_ticks"] * window * layers
    if (got != want or st["plain_calls"] or not st["chunk_ticks"]
            or not st["decode_ticks"]):
        raise AssertionError(f"{what}: K3 launches {got}, want {want}, "
                             f"plain calls {st['plain_calls']}")


def phase_paged_wide(torch, pa):
    """The paged engine at ``chunk=128, page_size=128`` (K3 at width 128
    over pages of 128) against the dense engine, GPT-2-small in f32 on the
    same weights: 4 requests (prompts of 300, 200, 150 and 64 tokens) x 32
    new tokens, token-exact; K3 launched; no page left in use."""
    from paddle_hackathon_tpu_torch.inference import ServingEngine
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.utils import load_jax_state
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device=DEV)
    load_jax_state(model, random_weights(model, seed=3))
    rng = np.random.RandomState(3)
    prompts = [rng.randint(0, cfg.vocab_size, n).astype(np.int32)
               for n in (300, 200, 150, 64)]
    kw = dict(max_slots=4, max_len=512, chunk=128, decode_window=32)
    outs, stats = {}, {}
    for mode in ("paged", "dense"):
        extra = {"page_size": 128} if mode == "paged" else {}
        eng = ServingEngine(model, auto_run=False,
                            cache_mode=mode, **kw, **extra)
        stats[mode] = counted_run(
            torch, pa, eng, lambda e=eng: [e.submit(p, 32) for p in prompts])
        outs[mode] = [r.result() for r in stats[mode].pop("requests")]
        if mode == "paged":
            engine_routes_ok(stats[mode], cfg.num_layers,
                             eng._decode_window, "tiles_tf32",
                             "paged engine at chunk 128 / pages of 128")
            eng.drop_prefix_cache()
            stats[mode]["kv_pages_in_use"] = eng.kv_pages_in_use
        del eng
    exact = sum(bool(np.array_equal(a, b))
                for a, b in zip(outs["paged"], outs["dense"]))
    emit({"phase": "paged_wide", "chunk": 128, "page_size": 128,
          "requests": 4, "new_tokens": 32, "token_exact_of_4": exact,
          **stats})
    p = stats["paged"]
    if exact != 4 or p["kv_pages_in_use"] != 0 \
            or any(stats["dense"]["kernel_launches"].values()):
        raise AssertionError(f"paged engine at chunk 128 / pages of 128: "
                             f"{exact} of 4 token-exact against dense, "
                             f"{stats}")
    del model
    torch.cuda.empty_cache()
    return p["kernel_launches"]


# divergence allowed between the bf16 paged and dense engines at D = 512:
# only where the dense model's own logits of the two tokens lie this close
# (bf16 rounding of P and of the attention output moves a logit by ~1e-2;
# the random model's top-2 logits lie ~0.14 apart on average)
BF16_MARGIN = 0.05


def phase_paged_wide512(torch, pa):
    """The paged engine at the wide512 GPT's heads (hidden 1024, 2 heads of
    D = 512, 2 layers), bf16, ``chunk=32``, pages of 16: its prefill
    chunks run K3's prefill kernel past 256 (``paged_attention_tc`` in
    256-column chunks, route ``tiles_wide_tc``), its decode steps the
    split kernel in column slices.  8 requests of 64 prompt tokens x
    16 new, counts set to 0 just before and read just after: the wide
    kernel launched exactly chunk ticks x layers, the plain version 0
    times, no page left in use; against the dense engine on the same
    weights each request token-exact, or diverging first where the dense
    model's own margin between the two tokens is within
    ``BF16_MARGIN``.  Returns the per-kernel launches."""
    from paddle_hackathon_tpu_torch.inference import ServingEngine
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.utils import load_jax_state
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0, **WIDE512_GPT)
    model = GPTForCausalLM(cfg, device=DEV, dtype="bfloat16")
    load_jax_state(model, random_weights(model, seed=4))
    rng = np.random.RandomState(4)
    prompts = [rng.randint(0, cfg.vocab_size, 64).astype(np.int32)
               for _ in range(8)]
    kw = dict(max_slots=8, max_len=256, chunk=32, decode_window=16)
    outs, stats = {}, {}
    for mode in ("paged", "dense"):
        extra = {"page_size": 16} if mode == "paged" else {}
        eng = ServingEngine(model, auto_run=False,
                            cache_mode=mode, **kw, **extra)
        stats[mode] = counted_run(
            torch, pa, eng, lambda e=eng: [e.submit(p, 16) for p in prompts])
        outs[mode] = [r.result() for r in stats[mode].pop("requests")]
        if mode == "paged":
            stats[mode]["decode_window"] = eng._decode_window
            eng.drop_prefix_cache()
            stats[mode]["kv_pages_in_use"] = eng.kv_pages_in_use
        del eng
    exact, margins = 0, []
    for p, a, b in zip(prompts, outs["paged"], outs["dense"]):
        diff = np.nonzero(a != b)[0]
        if not len(diff):
            exact += 1
            continue
        k = int(diff[0])
        margins.append({"position": k - len(p), "margin": margin_at(
            torch, model, b[:k], int(a[k]), int(b[k]))})
    emit({"phase": "paged_wide512", "model": WIDE512_GPT, "head_dim": 512,
          "chunk": 32, "page_size": 16, "requests": 8, "new_tokens": 16,
          "token_exact_of_8": exact, "divergences": margins,
          "margin_limit": BF16_MARGIN, **stats})
    p = stats["paged"]
    engine_routes_ok(p, cfg.num_layers, p["decode_window"], "tiles_wide_tc",
                     "paged engine at D = 512")
    if (not p["decode_ticks"] or p["kv_pages_in_use"]
            or any(stats["dense"]["kernel_launches"].values())
            or any(m["margin"] > BF16_MARGIN for m in margins)):
        raise AssertionError(f"paged engine at D = 512: {exact} of 8 "
                             f"token-exact, {margins}, {stats}")
    del model
    torch.cuda.empty_cache()
    return p["kernel_launches"]


def phase_paged_p12(torch, pa):
    """The paged engine over pages of 12 rows, GPT-2-small (12 layers,
    hidden 768, 12 heads of 64, N(0, 0.02) weights from a numpy seed), 16
    slots, chunk 32, in bf16 and in f32: no TMA box takes pages of 12 (a
    box of 4 rows), so its chunks run the gathered instances (bf16
    ``tiles_tc_g``, f32 ``tiles_tf32_g``), exactly chunk ticks x layers,
    and its decode steps the split kernel on TMA boxes (rows of 128 bytes:
    ``split``), exactly decode steps x layers; every other K3 kernel and
    the plain version 0 times, counts set to 0 just before and read just
    after; no page in use after the run; 8 requests of 64 prompt tokens x
    32 new, against the dense engine on the same weights token-exact, or
    diverging first where the dense model's own margin between the two
    tokens is within ``BF16_MARGIN`` (bf16) or 1e-3 (f32).  Returns the
    per-kernel launches of each run."""
    from paddle_hackathon_tpu_torch.inference import ServingEngine
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.utils import load_jax_state
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    rng = np.random.RandomState(12)
    prompts = [rng.randint(0, cfg.vocab_size, 64).astype(np.int32)
               for _ in range(8)]
    kw = dict(max_slots=16, max_len=512, chunk=32, decode_window=32)
    arrays, launched = None, {}
    for dtype, chunk_kernel, limit in (("bfloat16", "tiles_tc_g",
                                        BF16_MARGIN),
                                       ("float32", "tiles_tf32_g", 1e-3)):
        model = GPTForCausalLM(cfg, device=DEV, dtype=dtype)
        arrays = arrays or random_weights(model, seed=12)
        load_jax_state(model, arrays)
        outs, stats = {}, {}
        for mode in ("paged", "dense"):
            extra = {"page_size": 12} if mode == "paged" else {}
            eng = ServingEngine(model, auto_run=False,
                                cache_mode=mode, **kw, **extra)
            stats[mode] = counted_run(
                torch, pa, eng,
                lambda e=eng: [e.submit(p, 32) for p in prompts])
            outs[mode] = [r.result() for r in stats[mode].pop("requests")]
            if mode == "paged":
                engine_routes_ok(stats[mode], cfg.num_layers,
                                 eng._decode_window, chunk_kernel,
                                 f"paged engine at pages of 12, {dtype}")
                eng.drop_prefix_cache()
                stats[mode]["kv_pages_in_use"] = eng.kv_pages_in_use
            del eng
        exact, margins = 0, []
        for p, a, b in zip(prompts, outs["paged"], outs["dense"]):
            diff = np.nonzero(a != b)[0]
            if not len(diff):
                exact += 1
                continue
            k = int(diff[0])
            margins.append({"position": k - len(p), "margin": margin_at(
                torch, model, b[:k], int(a[k]), int(b[k]))})
        emit({"phase": "paged_p12", "dtype": dtype, "page_size": 12,
              "chunk": 32, "requests": 8, "new_tokens": 32,
              "token_exact_of_8": exact, "divergences": margins,
              "margin_limit": limit, **stats})
        p = stats["paged"]
        if (p["kv_pages_in_use"]
                or any(stats["dense"]["kernel_launches"].values())
                or any(m["margin"] > limit for m in margins)):
            raise AssertionError(f"paged engine at pages of 12 ({dtype}): "
                                 f"{exact} of 8 token-exact, {margins}, "
                                 f"{stats}")
        launched[dtype] = p["kernel_launches"]
        del model
        torch.cuda.empty_cache()
    return launched


def phase_profile(torch, eng, prompts):
    """Device time by kernel over 16 requests x 32 new tokens."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            eng.submit(p, 32)
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    eng.drop_prefix_cache()
    summary = profile_summary(torch, prof, wall)
    k3 = {name: sum(device_us(e) for e in prof.key_averages()
                    if str(getattr(e, "device_type", "")).endswith("CUDA")
                    and name in e.key) / 1e3
          for name in ("paged_decode_split", "paged_attention")}
    busy = summary["device_busy_s"] or float("nan")
    emit({"phase": "profile", "requests": 16, "new_tokens": 32, **summary,
          "k3_device_ms": k3, "k3_share_of_busy": {
              k: v / 1e3 / busy for k, v in k3.items()}})


# ---------------------------------------------------------------------------
# K4: the weight-only dequant GEMM, and serving from a quantized artifact
# ---------------------------------------------------------------------------

QUANT_SHAPES = {"qkv": (768, 2304), "out": (768, 768),      # (K, N)
                "fc_in": (768, 3072), "fc_out": (3072, 768)}
QUANT_ULP_LIMIT = 1.0           # bf16 ulps of the reference (JAX contract)
QUANT_F32_REL = 1e-5            # f32 activations: of max|ref|
SERVE_INT8 = dict(max_slots=8, max_len=224, chunk=32, decode_window=32)


def bf16_ulps(torch, got, ref, floor=None, bits=7):
    """Largest error of ``got`` in bf16 ulps of ``ref``: 2**(floor(log2
    |ref|) - 7) per element, or the bf16 ulp at ``floor`` (per element)
    where that is larger.  Zeros of ``ref`` without a floor count against
    1e-6.  ``bits=10`` reads f16 ulps."""
    got, ref = got.double(), ref.double()
    mag = ref.abs() if floor is None else torch.maximum(ref.abs(),
                                                        floor.double())
    ulp = torch.where(mag > 0, torch.exp2(torch.floor(torch.log2(
        mag.clamp_min(1e-300))) - bits), torch.full_like(mag, 1e-6))
    return float(((got - ref).abs() / ulp).max())


def sum_noise(torch, x2d, w_q, scale):
    """Each output's f32 accumulation noise, sqrt(K) 2**-24 sum_k |x_k w_k|
    s: the scale below which two orders of the same exact f32 products
    may differ.  Only outputs that cancel to near zero reach it; there a
    bf16 ulp of the result is smaller than the sum's own rounding (the
    control, a reordered plain version, reads up to 49 raw ulps there on
    the H100)."""
    k = x2d.shape[1]
    mag = x2d.float().abs() @ w_q.float().abs()
    return mag * scale * (k ** 0.5 * 2.0 ** -24)


def quant_case(torch, wo, m, k, n, scheme, xdtype, seed):
    """Activations N(0, 1) and a Normal(0, 0.02) weight quantized on the
    card by the port's quantizer."""
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(DEV, xdtype)
    w32 = torch.from_numpy((rng.randn(k, n) * 0.02).astype(np.float32))
    w_q, scale = wo.quantize_array(w32.to(DEV), scheme)
    return dict(x2d=x, w_q=w_q, scale=scale)


def reversed_chunks_ref(torch, x2d, w_q, scale):
    """The control: the plain version with K summed in reverse 128-row
    chunks (another order of the same exact products)."""
    acc = None
    for k0 in range(w_q.shape[0] - 128, -1, -128):
        part = x2d[:, k0:k0 + 128].float() @ w_q[k0:k0 + 128].float()
        acc = part if acc is None else acc + part
    return (acc * scale).to(x2d.dtype)


def reversed_chunks_exact(torch, x2d, w_q, scale):
    """The f16 control: the exact products summed in f64 in reverse 128-row
    chunks, rounded once to f32, times the scale (another order of the
    exact sum; an f32 sum's own noise is past one f16 ulp)."""
    acc = None
    for k0 in range(w_q.shape[0] - 128, -1, -128):
        part = x2d[:, k0:k0 + 128].double() @ w_q[k0:k0 + 128].double()
        acc = part if acc is None else acc + part
    return (acc.float() * scale).to(x2d.dtype)


def exact_sum(torch, x2d, w_q, scale):
    """The function's exact value: the exact products summed in f64,
    rounded once to f32, times the f32 scale, rounded to x's type.  An f32
    sum in any order (the plain version, the control) lies within its
    rounding noise of it; the kernel's order, exact tensor-core sums added
    into a two-float total, lies nearer."""
    return ((x2d.double() @ w_q.double()).float() * scale).to(x2d.dtype)


QUANT_CHECK_SHAPES = dict(QUANT_SHAPES, k640=(640, 384))
QUANT_CHECK_MS = (1, 8, 16, 17, 64, 72, 200, 256, 1024)
QUANT_REF_MS = (1, 8, 200, 256)       # the cases held to the plain version
QUANT_F32_MS = (1, 8, 17, 256, 1024)  # f32 activations


def phase_quant_checks(torch, qm, wo):
    """Each case's readings against the plain version ``quant_matmul_ref``
    (an f32 sum) and against the exact sum (:func:`exact_sum`).  Every
    case is held to the exact sum: the kernel and the control within the
    limit, the planted fault past it.  The four projections at M in
    ``QUANT_REF_MS`` are also held to the plain version, as they were
    before the kernel summed exactly.  The f32 plain version cannot be the
    yardstick of the other cases: it is itself more than one ulp from the
    exact sum in some of them (its own reversed-chunk control then fails
    against it), and in every f16 case (2-24 f16 ulps on the H100), where
    the kernel is within one."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, bad, max_abs = [], [], 0.0
    lim = QUANT_ULP_LIMIT
    for name, (k, n) in QUANT_CHECK_SHAPES.items():
        for scheme in ("int8", "fp8"):
            for m in QUANT_CHECK_MS:
                c = quant_case(torch, wo, m, k, n, scheme, torch.bfloat16,
                               seed=m + k + n)
                out = qm.quant_matmul_kernel(*c.values())
                torch.cuda.synchronize()
                ref = qm.quant_matmul_ref(*c.values())
                ex = exact_sum(torch, *c.values())
                ctl = reversed_chunks_ref(torch, **c)
                stale = c["w_q"].clone()
                stale[128:256] = c["w_q"][:128]       # a stale K tile
                fault = qm.quant_matmul_kernel(c["x2d"], stale, c["scale"])
                noise = sum_noise(torch, *c.values())
                r = [bf16_ulps(torch, out, ref, noise),
                     bf16_ulps(torch, ctl, ref, noise),
                     bf16_ulps(torch, fault, ref, noise),
                     bf16_ulps(torch, out, ref),
                     bf16_ulps(torch, out, ex, noise),
                     bf16_ulps(torch, ctl, ex, noise),
                     bf16_ulps(torch, fault, ex, noise),
                     bf16_ulps(torch, ref, ex, noise)]
                held_to_ref = name != "k640" and m in QUANT_REF_MS
                case = f"{name}_{scheme}_m{m}"
                ok = (r[4] <= lim and r[5] <= lim and r[6] > lim
                      and bool(torch.isfinite(out).all()))
                if held_to_ref:
                    ok = ok and r[0] <= lim and r[1] <= lim and r[2] > lim
                r.append(held_to_ref)
                if m == 256:
                    # the rows' sums depend neither on M nor on the tile
                    # nor on the schedule: rows 0 and 255 alone and the 8
                    # rows of a decode batch (the split) equal their rows
                    # of the batch of 256, and those equal their rows of a
                    # batch of 1024 (the walk), bit for bit
                    alone = [qm.quant_matmul_kernel(c["x2d"][i:i + 1],
                                                    c["w_q"], c["scale"])
                             for i in (0, 255)]
                    m8 = qm.quant_matmul_kernel(c["x2d"][:8].contiguous(),
                                                c["w_q"], c["scale"])
                    m1024 = qm.quant_matmul_kernel(c["x2d"].repeat(4, 1),
                                                   c["w_q"], c["scale"])
                    inv = (torch.equal(alone[0][0], out[0])
                           and torch.equal(alone[1][0], out[255])
                           and torch.equal(m8, out[:8])
                           and torch.equal(m1024[768:], out))
                    # three repeats of each schedule, bit for bit
                    rep = all(torch.equal(qm.quant_matmul_kernel(
                        c["x2d"][:8].contiguous(), c["w_q"], c["scale"]), m8)
                        and torch.equal(qm.quant_matmul_kernel(
                            *c.values()), out) for _ in range(3))
                    r += [inv, rep]
                    ok = ok and inv and rep
                max_abs = max(max_abs, float((out.float() - ref.float())
                                             .abs().max()))
                rows.append([case] + r)
                if not ok:
                    bad.append(case)
    # f32 activations (the CUDA-core kernel) at the four projections and
    # (640, 384), M in QUANT_F32_MS, int8 and e4m3 weights: within
    # QUANT_F32_REL of max|exact| (the exact products summed in f64, times
    # the scale), beside a control (the plain version with K summed in
    # reverse 128-row chunks, must pass) and a planted fault (the kernel on
    # a weight whose second K tile is a copy of its first, must fail);
    # every M's rows bit for bit their rows of M = 1024 (the split at
    # decode, the walk past it), three repeats bit for bit
    f32, max_abs_f32 = {}, 0.0
    for name, (k, n) in QUANT_CHECK_SHAPES.items():
        for scheme in ("int8", "fp8"):
            big = quant_case(torch, wo, max(QUANT_F32_MS), k, n, scheme,
                             torch.float32, k + n + 1)
            out_big = qm.quant_matmul_kernel(*big.values())
            for m in QUANT_F32_MS:
                c = dict(big, x2d=big["x2d"][:m].contiguous())
                out = qm.quant_matmul_kernel(*c.values())
                torch.cuda.synchronize()
                ex = (c["x2d"].double() @ c["w_q"].double()) \
                    * c["scale"].double()
                top = float(ex.abs().max())
                stale = c["w_q"].clone()
                stale[128:256] = c["w_q"][:128]       # a stale K tile
                got = {
                    "kernel": float((out.double() - ex).abs().max()) / top,
                    "control": float((reversed_chunks_ref(torch, **c)
                                      .double() - ex).abs().max()) / top,
                    "fault": float((qm.quant_matmul_kernel(
                        c["x2d"], stale, c["scale"]).double() - ex)
                        .abs().max()) / top,
                    "rows_equal_m1024": torch.equal(out, out_big[:m]),
                    "repeats_equal": all(torch.equal(
                        qm.quant_matmul_kernel(*c.values()), out)
                        for _ in range(3)),
                    "split": qm.quant_plan(m, k, n, torch.float32).split}
                max_abs_f32 = max(max_abs_f32, float(
                    (out - qm.quant_matmul_ref(*c.values())).abs().max()))
                case = f"{name}_{scheme}_m{m}"
                f32[case] = got
                if not (got["kernel"] <= QUANT_F32_REL
                        and got["control"] <= QUANT_F32_REL
                        and got["fault"] > QUANT_F32_REL
                        and got["rows_equal_m1024"] and got["repeats_equal"]
                        and bool(torch.isfinite(out).all())):
                    bad.append(f"f32_{case}")
            del big, out_big
    # f16 activations, in f16 ulps of the exact sum (the plain version's own
    # reading beside it): M = 8 at (768, 2304), and M = 256 at every shape
    # with its rows of M = 8 bit for bit, int8 and e4m3 weights alike (e4m3
    # through its two exponent bands), each beside a control (the exact
    # products summed in f64 in reverse 128-row chunks, must pass) and a
    # planted fault (the kernel on a weight whose second K tile is a copy
    # of its first, must fail)
    f16 = {}
    f16_cases = [("qkv", 8, 8)] + [(name, 256, None)
                                   for name in QUANT_CHECK_SHAPES]
    for name, m, seed in f16_cases:
        k, n = QUANT_CHECK_SHAPES[name]
        for scheme in ("int8", "fp8"):
            c = quant_case(torch, wo, m, k, n, scheme, torch.float16,
                           seed if seed is not None else m + k + n)
            out = qm.quant_matmul_kernel(*c.values())
            ref = qm.quant_matmul_ref(*c.values())
            ex = exact_sum(torch, *c.values())
            noise = sum_noise(torch, *c.values())
            stale = c["w_q"].clone()
            stale[128:256] = c["w_q"][:128]
            fault = qm.quant_matmul_kernel(c["x2d"], stale, c["scale"])
            ctl = reversed_chunks_exact(torch, **c)
            got = {"kernel_vs_exact": bf16_ulps(torch, out, ex, noise,
                                                bits=10),
                   "control_vs_exact": bf16_ulps(torch, ctl, ex, noise,
                                                 bits=10),
                   "fault_vs_exact": bf16_ulps(torch, fault, ex, noise,
                                               bits=10),
                   "kernel_vs_ref": bf16_ulps(torch, out, ref, noise,
                                              bits=10),
                   "ref_vs_exact": bf16_ulps(torch, ref, ex, noise, bits=10)}
            ok = (bool(torch.isfinite(out).all())
                  and got["kernel_vs_exact"] <= lim
                  and got["control_vs_exact"] <= lim
                  and got["fault_vs_exact"] > lim)
            if m == 256:
                got["m8_equal_m256"] = torch.equal(qm.quant_matmul_kernel(
                    c["x2d"][:8].contiguous(), c["w_q"], c["scale"]),
                    out[:8])
                ok = ok and got["m8_equal_m256"]
            case = f"{name}_{scheme}_m{m}"
            f16[case] = got
            if not ok:
                bad.append(f"f16_{case}")
    c = quant_case(torch, wo, 8, 768, 2304, "int8", torch.bfloat16, 9)
    bias = torch.randn(2304, device=DEV)
    x3 = c["x2d"].reshape(2, 4, 768)
    got = qm.quant_matmul(x3, c["w_q"], c["scale"], bias)
    kern = qm.quant_matmul_kernel(*c.values())
    three_d = (tuple(got.shape) == (2, 4, 2304) and torch.equal(
        got, (kern + bias.to(torch.bfloat16)).reshape(2, 4, 2304))
        and bf16_ulps(torch, kern, qm.quant_matmul_ref(*c.values()),
                      sum_noise(torch, *c.values())) <= lim)
    if not three_d:
        bad.append("3d_bias")
    emit({"phase": "quant_checks", "limit_ulps": lim,
          "fields": ["case", "kernel_vs_ref", "control_vs_ref",
                     "fault_vs_ref", "kernel_raw_vs_ref (no floor)",
                     "kernel_vs_exact", "control_vs_exact", "fault_vs_exact",
                     "ref_vs_exact", "held_to_ref",
                     "rows_alone_m8_m1024_equal_m256 (m256)",
                     "3_repeats_equal (m8 and m256)"],
          "checks": rows, "f32_rel_err": f32, "f32_limit": QUANT_F32_REL,
          "f16_ulps": f16,
          "bias_3d_ok": three_d, "max_abs_err": max_abs,
          "f32_max_abs_err": max_abs_f32})
    if bad:
        raise AssertionError(f"quant_matmul kernel disagrees with its plain "
                             f"version or the exact sum, or the limit does "
                             f"not separate the control from the planted "
                             f"fault: {bad}")
    return max_abs, max_abs_f32


def quant_bound(m, k, n, x_bytes=2, flops_peak=H100_BF16_FLOPS):
    """Least time for one product: x, w_q, scale and out moved once, or
    2 M K N flops at the peak for x's type (bf16/f16 tensor cores, f32 CUDA
    cores), whichever is larger."""
    nbytes = m * k * x_bytes + k * n + n * 4 + m * n * x_bytes
    flops = 2 * m * k * n
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / flops_peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def int8pack_runs(torch):
    """Whether this torch runs ``_weight_int8pack_mm`` on CUDA (the one
    library call that computes K4's int8 function); decided once, on a
    small input."""
    try:
        a = torch.ones(8, 128, device=DEV, dtype=torch.bfloat16)
        b = torch.ones(128, 128, device=DEV, dtype=torch.int8)
        s = torch.ones(128, device=DEV, dtype=torch.bfloat16)
        torch._weight_int8pack_mm(a, b, s)
        torch.cuda.synchronize()
        return True
    except (RuntimeError, NotImplementedError, AttributeError):
        return False


def k4_walk(torch, qm, x2d, w_q, scale):
    """The tensor-core kernel with each tile's chunks walked by one block
    (the walk), whatever the plan chooses: the schedule a prefill split
    replaces.  Not counted in ``launches``."""
    m, k = x2d.shape
    n = w_q.shape[1]
    out = torch.empty(m, n, dtype=x2d.dtype, device=x2d.device)
    err = qm._lib()(qm._X_CODES[x2d.dtype], qm._W_CODES[w_q.dtype],
                    x2d.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
                    out.data_ptr(), None, None, m, k, n, k // qm.CHUNK_ROWS,
                    torch._C._cuda_getCurrentRawStream(x2d.device.index))
    if err:
        raise RuntimeError(f"quant_matmul walk launch failed: {err}")
    return out


def quant_times(torch, qm, wo, m, k, n, xdtype, int8pack, scheme="int8"):
    """K4's time for one (m, k) x (k, n) int8 (or ``scheme``) product beside
    its bound, the plain version's and the yardsticks the port never calls:
    ``torch._weight_int8pack_mm`` (int8, where it runs for x's type) and
    cuBLAS on the widened weight in x's type.  Where the plan splits past
    one tile of x, the walk's time beside it (and its result, bit for
    bit)."""
    plan = qm.quant_plan(m, k, n, xdtype)
    c = quant_case(torch, wo, m, k, n, scheme, xdtype, m + n)
    per_copy = sum(t.numel() * t.element_size() for t in c.values())
    cases = copies(c, max(24, -(-60_000_000 // per_copy)))
    k_ms = device_ms(torch, [lambda c=c: qm.quant_matmul_kernel(*c.values())
                             for c in cases])
    p_ms = device_ms(torch, [lambda c=c: qm.quant_matmul_ref(*c.values())
                             for c in cases], reps=2)
    l_ms = lib_err = None
    if int8pack and scheme == "int8":   # weight transposed once, untimed
        try:
            libs = [(c["x2d"], c["w_q"].t().contiguous(),
                     c["scale"].to(xdtype)) for c in cases]
            lib_err = float((torch._weight_int8pack_mm(*libs[0]).float()
                             - qm.quant_matmul_kernel(*c.values()).float())
                            .abs().max())
            l_ms = device_ms(torch, [
                lambda a=a: torch._weight_int8pack_mm(*a) for a in libs])
            del libs
        except (RuntimeError, NotImplementedError):
            l_ms = lib_err = None
    # what an unquantized model of x's type runs instead: cuBLAS on the
    # widened weight of the same shape
    wides = [(c["x2d"], (c["w_q"].float() * c["scale"]).to(xdtype))
             for c in cases]
    cublas_ms = device_ms(torch, [lambda a=a: a[0] @ a[1] for a in wides])
    walk_ms = None
    if plan.split and m > qm.TILE_M:
        if not torch.equal(k4_walk(torch, qm, *c.values()),
                           qm.quant_matmul_kernel(*c.values())):
            raise AssertionError(f"quant_matmul split and walk differ at "
                                 f"{(m, k, n)}")
        walk_ms = device_ms(torch, [lambda c=c: k4_walk(torch, qm,
                                                        *c.values())
                                    for c in cases])
    del cases, wides
    f32 = xdtype == torch.float32
    b_ms, b_by = quant_bound(m, k, n, 4 if f32 else 2,
                             H100_F32_FLOPS if f32 else H100_BF16_FLOPS)
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "library_vs_kernel_max_abs": lib_err,
            ("f32" if f32 else "bf16") + "_cublas_ms": cublas_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "gbytes_per_s": (m * k * (4 if f32 else 2) + k * n + n * 4
                             + m * n * (4 if f32 else 2)) / k_ms / 1e6,
            "route": plan.route, "split": plan.split, "walk_ms": walk_ms}


def layer_sum(rows):
    """One layer's four projections: the sum of each time, ``bound_by``
    "operations" if any projection's bound is."""
    out = {"bound_by": "bytes"}
    for key in ("ms", "plain_ms", "bound_ms", "library_ms"):
        vals = [r[key] for r in rows]
        out[key] = None if None in vals else sum(vals)
    if any(r["bound_by"] != "bytes" for r in rows):
        out["bound_by"] = "operations"
    return out


def phase_quant(torch, qm, wo):
    int8pack = int8pack_runs(torch)
    timing = {}
    for name, (k, n) in QUANT_SHAPES.items():
        # M = 72: the spec phase's int8 verify tick (8 slots x width 9)
        for m in (8, 72, 256):
            timing[f"{name}_m{m}"] = quant_times(torch, qm, wo, m, k, n,
                                                 torch.bfloat16, int8pack)
        for m in (8, 256):
            timing[f"{name}_m{m}_f32"] = quant_times(
                torch, qm, wo, m, k, n, torch.float32, int8pack)
        # e4m3 weights: four exponent bands, eight products a k-step
        for m in (8, 256):
            timing[f"{name}_m{m}_fp8"] = quant_times(
                torch, qm, wo, m, k, n, torch.bfloat16, int8pack, "fp8")
    torch.cuda.empty_cache()
    layers = {tag: layer_sum([timing[f"{name}_{tag}"]
                              for name in QUANT_SHAPES])
              for tag in ("m8", "m72", "m256", "m8_f32", "m256_f32",
                          "m8_fp8", "m256_fp8")}
    emit({"phase": "quant", "weights": "int8 (fp8-e4m3 in the _fp8 rows)",
          "activations": "bf16 (f32 in the _f32 rows)",
          "library": "torch._weight_int8pack_mm" if int8pack else None,
          "timing": timing, "layers": layers,
          "note": "a layer: the sum of its four projections"})
    return layers["m8"], layers["m8_f32"], layers["m256_f32"], layers["m72"]


def serve_run(torch, eng, prompts, new):
    """One timed run of ``prompts`` through ``eng``; returns its readings and
    the model forwards it took."""
    s0 = dict(eng.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, new) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for r in reqs:
        toks = np.asarray(r.tokens)
        assert r.done and len(toks) == new, (r.done, len(toks))
    ttft = sorted(r.ttft_s for r in reqs)
    chunk = eng.stats["chunk_ticks"] - s0["chunk_ticks"]
    dec = eng.stats["decode_ticks"] - s0["decode_ticks"]
    return {"wall_s": wall, "tokens_per_s": len(prompts) * new / wall,
            "ttft_p50_s": ttft[len(ttft) // 2], "ttft_max_s": ttft[-1],
            "chunk_ticks": chunk, "decode_ticks": dec,
            "forwards": chunk + dec * eng._decode_window}


def ab_medians(path):
    """The ``--ab-medians FILE`` mode: the medians of the times in the
    ``--*-ab`` lines of FILE (each line's flat ``ms`` and, where it has
    them, ``sdpa_ms``), per tree (the line's ``pkg``) and shape, and over
    all trees for SDPA, beside the bounds the lines give: one JSON line."""
    import statistics
    trees, sdpa, bound = {}, {}, {}
    for ln in open(path):
        if not ln.startswith("{"):
            continue
        d = json.loads(ln)
        if not (d.get("phase", "").endswith("_ab") and "pkg" in d):
            continue
        tree = trees.setdefault(d["pkg"], {})
        for k, v in d["ms"].items():
            if isinstance(v, (int, float)):
                tree.setdefault(k, []).append(v)
        for k, v in d.get("sdpa_ms", {}).items():
            sdpa.setdefault(k, []).append(v)
        bound.update(d.get("bound_ms", {}))
    med = lambda xs: {k: statistics.median(v)  # noqa: E731
                      for k, v in xs.items()}
    emit({"phase": "ab_medians", "file": path,
          "trees": {pkg: {"runs": max(map(len, t.values())), "ms": med(t)}
                    for pkg, t in trees.items()},
          "sdpa_ms": med(sdpa), "bound_ms": bound})


def median_run(runs):
    return sorted(runs, key=lambda r: r["wall_s"])[len(runs) // 2]


def serving_ab(torch, runs):
    """The ``--serving-ab`` mode: the paged bf16 run of ``phase_serving``
    and the int8 run of ``phase_serving_int8``, ``runs`` times each, from
    the package on ``sys.path``; one JSON line a run, and one a round with
    the tree (``pkg``), both runs' wall ms and the host ms of one width-1
    ``gpt`` forward at 16 rows (``--ab-medians`` reads these); then one
    profiled paged run: busy and idle time and the host ops by count."""
    import shutil
    import tempfile

    from paddle_hackathon_tpu_torch.inference import (ServingEngine,
                                                      load_for_serving,
                                                      save_for_serving)
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.utils import load_jax_state

    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    bf16 = GPTForCausalLM(cfg, device=DEV, dtype="bfloat16")
    load_jax_state(bf16, random_weights(bf16, seed=0))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ab_")
    try:
        save_for_serving(bf16, tmp, quant="int8")
        int8 = load_for_serving(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    engines = {
        "paged": ServingEngine(bf16, auto_run=False,
                               cache_mode="paged", max_slots=16,
                               max_len=512, page_size=16, num_pages=257,
                               chunk=32, decode_window=32),
        "int8": ServingEngine(int8, auto_run=False, **SERVE_INT8)}
    rng = np.random.RandomState(0)
    prompts = {"paged": [rng.randint(0, cfg.vocab_size, 64).astype(np.int32)
                         for _ in range(16)]}
    prompts["int8"] = prompts["paged"][:8]
    for e in engines.values():                           # warm-up
        e.generate(rng.randint(0, cfg.vocab_size, 64), 2)
        e.drop_prefix_cache()
    import paddle_hackathon_tpu_torch as pkg
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (16, 1))).to(DEV)
    for i in range(runs):
        ms = {"gpt_forward_b16_s1": forward_host_ms(torch, bf16.gpt, ids)}
        for kind, e in engines.items():
            r = serve_run(torch, e, prompts[kind], 128)
            e.drop_prefix_cache()
            ms[f"{kind}_run"] = r["wall_s"] * 1e3
            emit({"phase": "serving_ab", "engine": kind, "run": i, **r})
        emit({"phase": "serving_ab", "pkg": pkg.__file__, "run": i,
              "ms": ms})
    # one profiled paged run: where the tree's host time goes
    e = engines["paged"]
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        r = serve_run(torch, e, prompts["paged"], 128)
    e.drop_prefix_cache()
    counts = sorted(((ev.key, ev.count) for ev in prof.key_averages()
                     if str(getattr(ev, "device_type", "")).endswith("CPU")),
                    key=lambda kv: -kv[1])
    emit({"phase": "serving_ab_profile", "pkg": pkg.__file__,
          **profile_summary(torch, prof, r["wall_s"]),
          "host_op_counts": dict(counts[:60])})


def layer_ab(torch, runs):
    """The ``--layer-ab`` mode: the host ms of one width-1 ``gpt`` forward
    at 16 rows (GPT-2-small bf16) with each cost the dygraph surface puts
    on a torch caller switched off in turn, interleaved in one process so
    that the machine's drift falls on every variant alike:
    ``module_call`` runs torch's own ``nn.Module.__call__`` in place of
    ``Layer.__call__``, ``plain_params`` makes the parameters plain
    ``nn.Parameter``s, ``unwrapped_f`` calls ``gelu`` and
    ``scaled_dot_product_attention`` without their ``takes_tensors``
    wrappers, ``all_off`` does all three; one JSON line a round."""
    from torch import nn

    import paddle_hackathon_tpu_torch as pkg
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.models import gpt as gpt_mod
    from paddle_hackathon_tpu_torch.nn.layer import Layer
    from paddle_hackathon_tpu_torch.nn.parameter import Parameter
    from paddle_hackathon_tpu_torch.utils import load_jax_state

    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    model = GPTForCausalLM(cfg, device=DEV, dtype="bfloat16")
    load_jax_state(model, random_weights(model, seed=0))
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (16, 1))).to(DEV)
    params = list(model.parameters())
    own_call = Layer.__dict__["__call__"]
    wrapped = {n: getattr(gpt_mod, n)
               for n in ("gelu", "scaled_dot_product_attention")}

    def variant(name):
        off = lambda what: name in (what, "all_off")  # noqa: E731
        Layer.__call__ = nn.Module.__call__ if off("module_call") \
            else own_call
        for q in params:
            q.__class__ = nn.Parameter if off("plain_params") else Parameter
        for n, f in wrapped.items():
            setattr(gpt_mod, n, f.__wrapped__ if off("unwrapped_f") else f)

    names = ["as_built", "module_call", "plain_params", "unwrapped_f",
             "all_off"]
    try:
        for i in range(runs):
            ms = {}
            for n in names[i % 5:] + names[:i % 5]:
                variant(n)
                ms[n] = forward_host_ms(torch, model.gpt, ids)
            emit({"phase": "layer_ab", "pkg": pkg.__file__, "run": i,
                  "ms": ms})
    finally:
        variant("as_built")


def forward_host_ms(torch, module, ids, reps=50):
    """Wall ms of one ``module(ids)`` call (inference mode, after 5
    warm-up calls), the mean of ``reps`` synchronised back to back: at a
    decode step's width a host-bound reading, so it moves with the
    Python work on each layer's call."""
    with torch.inference_mode():
        for _ in range(5):
            module(ids)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            module(ids)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


# K2's f32 dK/dV and dQ shapes of the --bwd-ab mode: the train_f32 step's
# attention (D = 64), BHD_WIDE_SHAPE (256), and past 256 the wide512
# GPT's heads (512) and a width whose last column part is one 32-column
# chunk (264)
BWD_AB_SHAPES = {"d64": dict(b=16, s=1024, H=12, D=64),
                 "d256": dict(b=8, s=1024, H=4, D=256),
                 "d264": dict(b=2, s=1024, H=2, D=264),
                 "d512": dict(b=2, s=1024, H=2, D=512)}


def bwd_ab(torch, runs):
    """The ``--bwd-ab`` mode: K2's f32 dK/dV and dQ device times at each
    of ``BWD_AB_SHAPES`` (causal), ``runs`` times, from the package on
    ``sys.path``; one JSON line a run."""
    import math

    from paddle_hackathon_tpu_torch.incubate.nn.kernels import _build
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        flash_attention as fa
    names = [f"flash_attention_{t}_f32" for t in ("w64", "w256", "wide")]
    _build.build_all(names)
    notes = {n: [ln.split("info    :")[-1].strip()
                 for ln in _build.build_logs.get(n, "").splitlines()
                 if "Performance Loss" in ln or "Used" in ln]
             for n in names}
    emit({"phase": "bwd_ab_build", "pkg": fa.__file__, "ptxas": notes})
    for i in range(runs):
        ms = {}
        for key, sh in BWD_AB_SHAPES.items():
            b, s, H, D = (sh[k] for k in "bsHD")
            scale = 1.0 / math.sqrt(D)
            q, k, v, do = bhd_case(torch, b * H, s, s, D, torch.float32,
                                   seed=7)
            o, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
            delta = (do * o).sum(-1)
            ms[key] = {
                "dkdv": device_ms(torch, [lambda: fa.flash_dkdv_kernel(
                    q, k, v, do, lse, delta, True, scale)]),
                "dq": device_ms(torch, [lambda: fa.flash_dq_kernel(
                    q, k, v, do, lse, delta, True, scale)])}
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
        emit({"phase": "bwd_ab", "pkg": fa.__file__, "run": i, "ms": ms})


def tc16_ab(torch, runs):
    """The ``--tc16-ab`` mode: K2's bf16 forward, dK/dV and dQ at each of
    ``K2_TC16_SHAPES`` and K1's three kernels at each of ``K1_AB_SHAPES``
    (causal, s = 1024), device times by graph replay, ``runs`` times, from
    the package on ``sys.path``; one JSON line a run.  First the ptxas
    report (registers, spills, performance notes) and HGMMA count of every
    kernel of the five libraries it builds, as this tree names them."""
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import _build
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        flash_attention as fa
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        flash_attention_packed as fap
    names = [f"flash_attention_w{dp}_h" for dp in _build.FLASH_WIDTHS] + [
        f"flash_attention_packed_w{dp}" for dp in (64, 256)]
    libs = _build.build_all(names)

    def name(ln):
        m = re.search(r"_Z\w+", ln)
        return m.group(0) if m else None
    emit({"phase": "tc16_ab_build", "pkg": fa.__file__,
          "ptxas": ptxas_notes(_build, names, name),
          "hgmma": hgmma_counts(_build, libs, names, name)})
    for i in range(runs):
        ms = {}
        for key, sh in K2_TC16_SHAPES.items():
            q, k, v, do, o, lse, delta, sc = k2_tc16_case(torch, fa, sh, 7)
            ms[f"k2_{key}"] = {
                "fwd": device_ms(torch, [
                    lambda: fa.flash_fwd_kernel(q, k, v, True, sc)]),
                "dkdv": device_ms(torch, [lambda: fa.flash_dkdv_kernel(
                    q, k, v, do, lse, delta, True, sc)]),
                "dq": device_ms(torch, [lambda: fa.flash_dq_kernel(
                    q, k, v, do, lse, delta, True, sc)])}
            del q, k, v, do, o, lse, delta
            torch.cuda.empty_cache()
        for key, sh in K1_AB_SHAPES.items():
            b, s, H, D = (sh[c] for c in "bsHD")
            sc = 1.0 / D ** 0.5
            qkv, dout = flash_case(torch, b, s, H, D, torch.bfloat16, 8)
            o, lse = fap.flash_packed_fwd_kernel(qkv, H, True, sc)
            delta = fap._delta(o, dout, H)
            dqkv = torch.empty_like(qkv)
            ms[f"k1_{key}"] = {
                "fwd": device_ms(torch, [lambda: fap.flash_packed_fwd_kernel(
                    qkv, H, True, sc)]),
                "dkdv": device_ms(torch, [
                    lambda: fap.flash_packed_dkdv_kernel(
                        qkv, dout, lse, delta, dqkv, H, True, sc)]),
                "dq": device_ms(torch, [lambda: fap.flash_packed_dq_kernel(
                    qkv, dout, lse, delta, dqkv, H, True, sc)])}
            del qkv, dout, o, lse, delta, dqkv
            torch.cuda.empty_cache()
        emit({"phase": "tc16_ab", "pkg": fa.__file__, "run": i, "ms": ms})


# K3's shapes of the --k3-ab mode: the f32 prefill chunks and decode past
# 256, the split decode up to 256, the bf16/f16 chunks on paged TMA +
# wgmma, and the shapes the retired kernels ran (K3_RETIRED_SHAPES)
def k3_ab_cases(torch):
    kc = kernel_case
    return {
        "f32_w32_serving": f32_case(serving_case(torch, 32, seed=32)),
        "f32_w128_p128": kc(torch, torch.float32, 128, seed=129, P=128,
                            maxp=4),
        "f32_d256_w32": kc(torch, torch.float32, 32, seed=288, D=256,
                           maxp=8),
        "f32_d512_w32": kc(torch, torch.float32, 32, seed=546, D=512,
                           maxp=8),
        "bf16_d512_w1": kc(torch, torch.bfloat16, 1, seed=515, D=512,
                           maxp=8),
        "f16_d512_w1": kc(torch, torch.float16, 1, seed=515, D=512, maxp=8),
        "f32_d512_w1": kc(torch, torch.float32, 1, seed=515, D=512, maxp=8),
        "bf16_w1_serving": serving_case(torch, 1, seed=1),
        "bf16_w1_maxlen": kc(torch, torch.bfloat16, 1, seed=1),
        "bf16_w32_serving": serving_case(torch, 32, seed=32),
        "bf16_w128_p128": kc(torch, torch.bfloat16, 128, seed=129, P=128,
                             maxp=4),
        "bf16_d512_w32": kc(torch, torch.bfloat16, 32, seed=546, D=512,
                            maxp=8),
        "f16_w32_serving": {k: v.half() if v.is_floating_point() else v
                            for k, v in serving_case(torch, 32,
                                                     seed=32).items()},
        "bf16_d128_w32": kc(torch, torch.bfloat16, 32, seed=160, D=128),
        "bf16_d256_w32": kc(torch, torch.bfloat16, 32, seed=288, D=256),
        "bf16_d128_w128": kc(torch, torch.bfloat16, 128, seed=256, D=128,
                             P=128, maxp=4),
        "bf16_d256_w128": kc(torch, torch.bfloat16, 128, seed=384, D=256,
                             P=128, maxp=4),
        **k3_retired_cases(torch)}


def k3_ab(torch, runs):
    """The ``--k3-ab`` mode: K3's device time at each of ``k3_ab_cases``
    (graph replay over input copies larger than the L2), ``runs`` times,
    from the package on ``sys.path``; one JSON line a run, each shape with
    the kernel that tree routes it to.  First the ptxas report and HGMMA
    count of every kernel of the paged library, as this tree names them."""
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import _build
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        paged_attention as pa
    libs = _build.build_all(["paged_attention"])

    def name(ln):
        m = re.search(r"_Z\w+", ln)
        return m.group(0) if m else None
    emit({"phase": "k3_ab_build", "pkg": pa.__file__,
          "ptxas": ptxas_notes(_build, ["paged_attention"], name),
          "hgmma": hgmma_counts(_build, libs, ["paged_attention"], name)})
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = k3_ab_cases(torch)
    routes = {k: pa.tile_route(c["q"].shape[1], c["q"].shape[3],
                               c["q"].dtype, c["k_pool"].shape[1])
              for k, c in cases.items()}
    import torch.nn.functional as F
    retired = {name for name, *_ in K3_RETIRED_SHAPES}
    for i in range(runs):
        ms, sdpa = {}, {}
        for key, case in cases.items():
            cs = copies(case)
            ms[key] = device_ms(torch, [
                lambda c=c: pa.paged_attention_kernel(**c) for c in cs])
            if key in retired:                # beside SDPA, this run
                libs = [gathered(torch, c) for c in cs]
                sdpa[key] = device_ms(torch, [
                    lambda a=a: F.scaled_dot_product_attention(
                        a[0], a[1], a[2], attn_mask=a[3]) for a in libs])
                del libs
            del cs
            torch.cuda.empty_cache()
        emit({"phase": "k3_ab", "pkg": pa.__file__, "run": i, "ms": ms,
              "sdpa_ms": sdpa, "routes": routes,
              "bound_ms": {k: k3_bound(cases[k])[0] for k in retired}})


K4_AB_MS = (8, 256)


def k4_ab(torch, runs):
    """The ``--k4-ab`` mode: K4's device time for one GPT-2-small layer's
    four int8 projections (graph replay over input copies larger than the
    L2) at M in ``K4_AB_MS``, f32 and bf16 activations, ``runs`` times,
    from the package on ``sys.path``; one JSON line a run, the plan of
    each projection beside it.  First the quant_matmul library's ptxas
    report, as this tree names its kernels."""
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import _build
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        quant_matmul as qm
    from paddle_hackathon_tpu_torch.nn.quant import weight_only as wo
    _build.build_all(["quant_matmul"])

    def name(ln):
        m = re.search(r"_Z\w+", ln)
        return m.group(0) if m else None
    emit({"phase": "k4_ab_build", "pkg": qm.__file__,
          "ptxas": ptxas_notes(_build, ["quant_matmul"], name)})
    cases, plans = {}, {}
    for xdtype in (torch.float32, torch.bfloat16):
        for m in K4_AB_MS:
            for pname, (k, n) in QUANT_SHAPES.items():
                key = f"{str(xdtype).split('.')[-1]}_m{m}_{pname}"
                c = quant_case(torch, wo, m, k, n, "int8", xdtype, m + n)
                per_copy = sum(t.numel() * t.element_size()
                               for t in c.values())
                cases[key] = copies(c, max(24, -(-60_000_000 // per_copy)))
                plans[key] = tuple(qm.quant_plan(m, k, n, xdtype))
    for i in range(runs):
        ms = {key: device_ms(torch, [
            lambda c=c: qm.quant_matmul_kernel(*c.values()) for c in cs])
            for key, cs in cases.items()}
        layers = {}
        for key, v in ms.items():
            tag = "_".join(key.split("_")[:2])      # <dtype>_m<M>
            layers[tag] = layers.get(tag, 0.0) + v
        emit({"phase": "k4_ab", "pkg": qm.__file__, "run": i,
              "layers": layers, "ms": ms, "plans": plans})


def phase_serving_int8(torch, qm):
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from paddle_hackathon_tpu_torch.inference import (ServingEngine,
                                                      load_for_serving,
                                                      save_for_serving)
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.observability import get_registry
    from paddle_hackathon_tpu_torch.utils import load_jax_state

    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    bf16 = GPTForCausalLM(cfg, device=DEV, dtype="bfloat16")
    arrays = random_weights(bf16, seed=0)
    load_jax_state(bf16, arrays)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    try:
        t0 = time.perf_counter()
        save_for_serving(bf16, tmp, quant="int8")
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        int8 = load_for_serving(tmp)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert int8.device.type == torch.device(DEV).type, int8.device
    engines = {"bf16": ServingEngine(bf16, auto_run=False, **SERVE_INT8),
               "int8": ServingEngine(int8, auto_run=False, **SERVE_INT8)}
    # the engines' serving_weight_bytes gauges: params (quant scales
    # included) and buffers, as the JAX engine counts them
    reg = get_registry()
    bytes_ = {k: reg.total("serving_weight_bytes", engine=e.engine_id)
              for k, e in engines.items()}
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, cfg.vocab_size, 64).astype(np.int32)
               for _ in range(8)]
    for e in engines.values():                           # warm-up
        e.generate(rng.randint(0, cfg.vocab_size, 64), 2)

    plain_calls = [0]
    plain = qm.quant_matmul_ref

    def counted_plain(*a, **kw):
        plain_calls[0] += 1
        return plain(*a, **kw)

    runs = {"bf16": [], "int8": []}
    launches = None
    for order in (("bf16", "int8"), ("int8", "bf16"), ("bf16", "int8")):
        for kind in order:
            qm.launches = 0
            qm.quant_matmul_ref = counted_plain
            try:
                r = serve_run(torch, engines[kind], prompts, 128)
            finally:
                qm.quant_matmul_ref = plain
            r["k4_launches"] = qm.launches
            # 4 projections per layer per forward
            need = 4 * cfg.num_layers * r["forwards"] if kind == "int8" else 0
            if r["k4_launches"] != need:
                raise AssertionError(f"{kind}: K4 launches "
                                     f"{r['k4_launches']} != {need}")
            if launches is None and kind == "int8":
                launches = r["k4_launches"]
            runs[kind].append(r)
    if plain_calls[0]:
        raise AssertionError(f"quant_matmul_ref ran {plain_calls[0]} times "
                             f"on the card's serving path")
    med = {k: median_run(v) for k, v in runs.items()}
    emit({"phase": "serving_int8", "model": "gpt2-small-en",
          "requests": 8, "prompt": 64, "new_tokens": 128, **SERVE_INT8,
          "artifact_save_s": t_save, "artifact_load_s": t_load,
          "median": med,
          "int8_over_bf16_tokens_per_s": (med["int8"]["tokens_per_s"]
                                          / med["bf16"]["tokens_per_s"]),
          "pair_ratios": [i["tokens_per_s"] / b["tokens_per_s"]
                          for b, i in zip(runs["bf16"], runs["int8"])],
          "weight_bytes": bytes_,
          "weight_bytes_ratio": bytes_["int8"] / bytes_["bf16"],
          "k4_launches_per_forward": launches / med["int8"]["forwards"],
          "plain_calls": plain_calls[0], "runs": runs})

    # one profiled int8 run: idle share and K4's share of device time
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for p in prompts:
            engines["int8"].submit(p, 32)
        engines["int8"].run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summ = profile_summary(torch, prof, wall)
    k4_us = sum(device_us(e) for e in prof.key_averages()
                if "quant_matmul" in e.key and str(getattr(
                    e, "device_type", "")).endswith("CUDA"))
    busy = summ["device_busy_s"]
    emit({"phase": "quant_profile", "requests": 8, "new_tokens": 32,
          "k4_device_ms": k4_us / 1e3,
          "k4_share_of_busy": (k4_us / 1e6 / busy) if busy else None,
          **summ})
    del engines, bf16
    torch.cuda.empty_cache()
    return launches, arrays, prompts, int8


def phase_quant_f32_cross_check(torch, qm, arrays, prompts):
    import shutil
    import tempfile

    from paddle_hackathon_tpu_torch.inference import (ServingEngine,
                                                      load_for_serving,
                                                      save_for_serving)
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.utils import load_jax_state

    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    m32 = GPTForCausalLM(cfg, device=DEV)
    load_jax_state(m32, arrays)
    res, bad = {}, []
    qm.f32_launches = 0
    for scheme in ("int8", "fp8"):
        tmp = tempfile.mkdtemp(prefix="chip_smoke_f32_")
        try:
            save_for_serving(m32, tmp, quant=scheme)
            mq = load_for_serving(tmp)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        ref = mq.generate(np.stack(prompts[:4]), 32,
                          temperature=0.0).cpu().numpy()
        for mode in ("dense", "paged"):
            e = ServingEngine(mq, auto_run=False,
                              cache_mode=mode, **SERVE_INT8)
            rs = [e.submit(p, 32) for p in prompts[:4]]
            e.run_until_idle()
            same = [bool(np.array_equal(r.result(), ref[i]))
                    for i, r in enumerate(rs)]
            res[f"{scheme}_{mode}"] = sum(same)
            if not all(same):
                bad.append(f"{scheme}_{mode}")
        del mq
    f32_launches = qm.f32_launches
    emit({"phase": "quant_f32_cross_check", "requests": 4, "new_tokens": 32,
          "token_exact_of_4": res, "k4_f32_launches": f32_launches})
    if not f32_launches:
        bad.append("no f32 K4 launch")
    if bad:
        raise AssertionError(f"quantized f32 engines diverge from the same "
                             f"model's generate: {bad}")
    del m32
    torch.cuda.empty_cache()
    return f32_launches


# ---------------------------------------------------------------------------
# Speculative decoding: generate and the engines' verify tick
# ---------------------------------------------------------------------------

SPEC_K = 8                  # the JAX bench's decode_spec / serving_spec rows
SPEC_NEW = 128
SPEC_ENGINE = dict(SERVE_INT8, spec_k=SPEC_K)


def spec_prompts(vocab):
    """The serving_int8 phase's 8 prompts of 64 tokens, the second one
    replaced by the first's first 8 tokens repeated 8 times: a repeated
    prompt, as the JAX bench's serving_spec row feeds one, so that the
    n-gram drafter proposes from the start."""
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, vocab, 64).astype(np.int32) for _ in range(8)]
    prompts[1] = np.tile(prompts[0][:8], 8)
    return prompts


def counted_launches(torch, pa, qm, run):
    """``run()`` with K3's launches by kernel, K4's launches and both plain
    versions' calls set to 0 just before and read just after."""
    plain = {"paged_attention_ref": 0, "quant_matmul_ref": 0}
    real_pa = counting(pa, ["paged_attention_ref"], plain)
    real_qm = counting(qm, ["quant_matmul_ref"], plain)
    for counts in (pa.launches, pa.kernel_launches):
        for k in counts:
            counts[k] = 0
    qm.launches = 0
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        restore(pa, real_pa)
        restore(qm, real_qm)
    return out, {"k3": {k: n for k, n in pa.kernel_launches.items() if n},
                 "k4": qm.launches, "plain_calls": sum(plain.values())}


def spec_serve(torch, eng, prompts):
    """One timed run of ``prompts`` x SPEC_NEW through ``eng``: the
    outputs, and the run's wall, tokens/s, ticks by flavor and spec
    counters."""
    s0 = dict(eng.stats)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.submit(p, SPEC_NEW) for p in prompts]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {k: eng.stats[k] - s0[k] for k in (
        "chunk_ticks", "decode_ticks", "spec_ticks", "spec_drafted",
        "spec_accepted", "tokens")}
    return np.stack([r.result() for r in reqs]), dict(
        wall_s=wall, tokens_per_s=len(prompts) * SPEC_NEW / wall, **d)


def spec_generate(torch, model, ids, spec_k):
    """One timed greedy ``generate`` of the batch, with or without spec."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = model.generate(ids, SPEC_NEW, temperature=0.0, spec_k=spec_k)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = {"wall_s": wall, "tokens_per_s": ids.shape[0] * SPEC_NEW / wall}
    if spec_k:
        st = model._last_spec_stats
        row.update(spec_ticks=st["ticks"], spec_drafted=st["proposed"],
                   spec_accepted=st["accepted"])
    return out.cpu().numpy(), row


def spec_pairs(torch, pa, qm, name, plain_fn, spec_fn, want):
    """Three pairs of runs, alternated (plain, spec; spec, plain; plain,
    spec): every spec run token-exact against the first plain run, every
    run's launches exactly ``want(readings, spec)`` and 0 plain calls.
    Returns the runs and the medians by wall time."""
    runs = {"plain": [], "spec": []}
    ref = None
    for order in (("plain", "spec"), ("spec", "plain"), ("plain", "spec")):
        for kind in order:
            (out, row), counts = counted_launches(
                torch, pa, qm, plain_fn if kind == "plain" else spec_fn)
            row["launches"] = counts
            expect = want(row, kind == "spec")
            if counts["plain_calls"] or counts["k3"] != expect["k3"] \
                    or counts["k4"] != expect["k4"]:
                raise AssertionError(f"spec {name} {kind}: launches "
                                     f"{counts}, want {expect} and 0 plain "
                                     f"calls")
            if kind == "plain" and ref is None:
                ref = out
            elif not np.array_equal(out, ref):
                bad = np.argwhere(out != ref)[:4].tolist()
                raise AssertionError(f"spec {name} {kind}: not token-exact "
                                     f"against the run without spec at "
                                     f"(row, position) {bad}")
            runs[kind].append(row)
    med = {k: median_run(v) for k, v in runs.items()}
    spec = med["spec"]
    out = {"spec": spec, "plain": med["plain"],
           "spec_over_plain_tokens_per_s": (spec["tokens_per_s"]
                                            / med["plain"]["tokens_per_s"]),
           "acceptance_rate": (spec["spec_accepted"]
                               / max(spec["spec_drafted"], 1)),
           "spec_ticks": spec["spec_ticks"], "token_exact": True,
           "plain_calls": 0, "runs": runs}
    return out, ref


def device_memory_gauges():
    """``observability.record_device_memory`` on the card: card 0's three
    gauges from a registry of their own, which must be the caching
    allocator's readings (in use > 0, at most the peak and the reserved
    bytes)."""
    from paddle_hackathon_tpu_torch.observability import (
        MetricRegistry, record_device_memory)
    reg = MetricRegistry(enabled=True)
    record_device_memory(reg)
    got = {}
    for ln in reg.expose_text().splitlines():
        m = re.match(r'device_memory_bytes_(\w+)\{device="0"\} (\S+)$', ln)
        if m:
            got[m.group(1)] = float(m.group(2))
    if not (set(got) == {"in_use", "peak", "reserved"}
            and 0 < got["in_use"] <= got["peak"]
            and got["in_use"] <= got["reserved"]):
        raise AssertionError(f"record_device_memory on the card: {got}")
    return got


def phase_spec(torch, pa, qm, int8=None, cfg_overrides=None):
    """Speculative decoding at the full width of GPT-2-small (bf16,
    N(0, 0.02) weights from a numpy seed), spec_k = 8, n-gram drafter
    unless named: (a) ``generate`` at batch 8, prompt 64, 128 new tokens;
    (b) the dense engine (8 streams, max_len 224, chunk 32, window 32);
    (c) the same on the paged engine over pages of 16; (d) the same through
    the int8 artifact (``int8``: the serving_int8 phase's model; saved and
    loaded here when None); (e) the dense engine with a 2-layer
    ``ModelDrafter`` at the same width and vocab (the target truncated to
    its first two blocks).  Each run token-exact
    against the same path without spec, tokens/s median of 3 alternated
    pairs; launches exact: 12 ``paged_decode_split`` a paged verify tick
    (and 12 a decode step, ``paged_attention_tc`` 12 a chunk tick), 48 K4
    a forward of the int8 engine (a verify tick is one forward, M = 8 x 9
    = 72); 0 plain calls; no page left in use.  Then the paged engine's
    steady-state ticks under ``forbid_host_transfers()``, with a planted
    ``.item()`` inside the same block, which must raise; and the card's
    device-memory gauges through ``record_device_memory``."""
    import shutil
    import tempfile

    from paddle_hackathon_tpu_torch.inference import (ServingEngine,
                                                      load_for_serving,
                                                      save_for_serving)
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.observability import (
        HostTransferError, forbid_host_transfers)
    from paddle_hackathon_tpu_torch.utils import load_jax_state

    kw = dict(hidden_dropout_prob=0.0, attention_dropout_prob=0.0,
              **(cfg_overrides or {}))
    cfg = gpt_config("gpt2-small-en", **kw)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, device=DEV, dtype="bfloat16")
    load_jax_state(model, random_weights(model, seed=0))
    if int8 is None:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_spec_int8_")
        try:
            save_for_serving(model, tmp, quant="int8")
            int8 = load_for_serving(tmp, device=DEV)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    prompts = spec_prompts(cfg.vocab_size)
    W = SPEC_ENGINE["decode_window"]
    none = lambda row, spec: {"k3": {}, "k4": 0}  # noqa: E731
    report = {}

    # (a) generate
    ids = torch.tensor(np.stack(prompts), device=DEV)
    spec_generate(torch, model, ids[:, :16], SPEC_K)       # warm-up
    report["a_generate"], _ = spec_pairs(
        torch, pa, qm, "generate",
        lambda: spec_generate(torch, model, ids, 0),
        lambda: spec_generate(torch, model, ids, SPEC_K), none)

    def engines(m, **extra):
        out = {}
        for kind, k in (("plain", 0), ("spec", SPEC_K)):
            e = ServingEngine(m, auto_run=False,
                              **dict(SPEC_ENGINE, spec_k=k, **extra))
            e.generate(prompts[1], 16)                     # warm-up
            out[kind] = e
        return out

    def pairs(name, engs, want):
        return spec_pairs(torch, pa, qm, name,
                          lambda: spec_serve(torch, engs["plain"], prompts),
                          lambda: spec_serve(torch, engs["spec"], prompts),
                          want)

    # (b) the dense engine
    dense = engines(model)
    report["b_dense"], ref_b = pairs("dense", dense, none)

    # (c) the paged engine: K3 on every tick
    def k3_want(row, spec):
        k3 = {"tiles_tc": L * row["chunk_ticks"],
              "split": L * (row["spec_ticks"] + W * row["decode_ticks"])}
        return {"k3": {k: n for k, n in k3.items() if n}, "k4": 0}
    paged = engines(model, cache_mode="paged", page_size=16)
    leaked = {}

    def paged_run(kind):
        out = spec_serve(torch, paged[kind], prompts)
        paged[kind].drop_prefix_cache()
        leaked[kind] = paged[kind].kv_pages_in_use
        if leaked[kind]:
            raise AssertionError(f"paged {kind}: {leaked[kind]} pages "
                                 f"left in use")
        return out
    report["c_paged"], ref_c = spec_pairs(
        torch, pa, qm, "paged", lambda: paged_run("plain"),
        lambda: paged_run("spec"), k3_want)
    report["c_paged"]["kv_pages_in_use"] = 0
    k3_launches = report["c_paged"]["runs"]["spec"][0]["launches"]["k3"]

    # the steady-state verify and decode ticks under the transfer guard,
    # with a planted implicit fetch in the same block as the control
    eng = paged["spec"]
    s0 = dict(eng.stats)
    reqs = [eng.submit(p, SPEC_NEW) for p in prompts]
    while eng._pending or any(s.req is not None and s.off < len(s.seq)
                              for s in eng._slots):
        eng.step()
    guarded = 0
    with forbid_host_transfers():
        while eng.step():
            guarded += 1
        try:
            eng._caches[0][0].sum().item()
            planted = False
        except HostTransferError:
            planted = True
    out = np.stack([r.result() for r in reqs])
    guard = {"guarded_ticks": guarded,
             "guarded_spec_ticks": eng.stats["spec_ticks"]
             - s0["spec_ticks"], "planted_item_raised": planted,
             "token_exact": bool(np.array_equal(out, ref_c))}
    if not guard["token_exact"]:
        guard["diff_at"] = np.argwhere(out != ref_c)[:8].tolist()
    eng.drop_prefix_cache()
    if not (guard["guarded_ticks"] and guard["guarded_spec_ticks"]
            and planted and guard["token_exact"]
            and eng.kv_pages_in_use == 0):
        raise AssertionError(f"spec paged ticks under "
                             f"forbid_host_transfers: {guard}")
    report["c_paged"]["forbid_host_transfers"] = guard
    report["device_memory"] = device_memory_gauges()
    del paged, eng

    # (d) the int8 artifact: K4 on every projection of every forward
    def k4_want(row, spec):
        fwd = row["chunk_ticks"] + W * row["decode_ticks"] + row["spec_ticks"]
        return {"k3": {}, "k4": 4 * L * fwd}
    q = engines(int8)
    report["d_int8"], _ = pairs("int8", q, k4_want)
    k4_launches = report["d_int8"]["runs"]["spec"][0]["launches"]["k4"]
    del q

    # (e) a 2-layer draft model at the same width and vocab: from the
    # target's seed, so it holds the target's embeddings and first two
    # blocks (a draft of unrelated random weights accepted none of its
    # drafts on the H100)
    draft = GPTForCausalLM(gpt_config("gpt2-small-en", **dict(kw,
                                                              num_layers=2)),
                           device=DEV, dtype="bfloat16")
    load_jax_state(draft, random_weights(draft, seed=0))
    dm = engines(model, drafter=draft)
    report["e_model_drafter"], ref_e = pairs("model_drafter", dm, none)
    if not np.array_equal(ref_e, ref_b):
        raise AssertionError("the dense engine's runs without spec differ "
                             "between (b) and (e)")
    del dense, dm, draft
    torch.cuda.empty_cache()
    emit({"phase": "spec", "model": "gpt2-small-en bf16", "spec_k": SPEC_K,
          "requests": len(prompts), "prompt": 64, "new_tokens": SPEC_NEW,
          "engine": SPEC_ENGINE, "layers": L, **report})
    return {"k3": k3_launches, "k4": k4_launches}


# ---------------------------------------------------------------------------
# The engine's scheduler stages: priority classes, preemption, sessions,
# defrag, deadlines, streams, the auto_run loop and the reports
# ---------------------------------------------------------------------------

# the serving geometry; 128 usable pages hold 9 footprints of a batch
# request (64 + 128 tokens and the chunk's reserve: 14 pages), so most of
# the batch backlog queues and the interactive arrivals (64 + 64: 10 pages
# each) admit by preemption
STAGES_ENGINE = dict(cache_mode="paged", max_slots=16, max_len=512,
                     page_size=16, chunk=32, decode_window=8)
STAGES_PAGES = 129
STAGES_BATCH = (24, 64, 128)        # requests, prompt, new tokens
STAGES_INTER = (8, 64, 64)
STAGES_ARRIVAL = 16                 # ticks before the interactive arrivals


def stage_engine(model, **kw):
    """An engine, driven synchronously unless ``auto_run=True`` is given,
    whose chunk-flavoured forwards are recorded as wide (``chunk``) or not
    (every row a single token): K3 runs its prefill kernel on the first
    and its split kernel on the second."""
    from paddle_hackathon_tpu_torch.inference import ServingEngine
    eng = ServingEngine(model, **dict({"auto_run": False}, **kw))
    widths = eng.stage_widths = []
    real = eng._run_tick

    def run(tokens, starts, nvalid, sampling):
        widths.append(int(nvalid.max()) > 1)
        return real(tokens, starts, nvalid, sampling)
    eng._run_tick = run
    return eng


def stage_counted(torch, pa, qm, eng, run, layers):
    """``run()`` with K3's and K4's counts and both plain versions' calls
    set to 0 just before and read just after, held to what the engine's
    ticks of that run need: paged, ``tiles_tc`` once a layer for each wide
    chunk tick and ``split`` once a layer for each width-1 forward (a
    narrow chunk tick, ``decode_window`` a decode tick) and each verify
    tick; an int8 model, K4 four times a layer each forward; 0 plain
    calls.  Returns ``run()``'s value and the counts beside the ticks."""
    s0 = dict(eng.stats)
    w0 = len(eng.stage_widths)
    out, counts = counted_launches(torch, pa, qm, run)
    d = {k: eng.stats[k] - s0[k]
         for k in ("chunk_ticks", "decode_ticks", "spec_ticks")}
    wide = sum(eng.stage_widths[w0:])
    W = eng._decode_window
    width1 = d["chunk_ticks"] - wide + W * d["decode_ticks"]
    fwd = d["chunk_ticks"] + W * d["decode_ticks"] + d["spec_ticks"]
    k3 = ({"tiles_tc": layers * wide,
           "split": layers * (width1 + d["spec_ticks"])}
          if eng._paged else {})
    want = {"k3": {k: n for k, n in k3.items() if n},
            "k4": 4 * layers * fwd if eng._quantized else 0}
    if (counts["plain_calls"] or counts["k3"] != want["k3"]
            or counts["k4"] != want["k4"] or not fwd):
        raise AssertionError(f"stages: launches {counts}, want {want} and "
                             f"0 plain calls (ticks {d}, wide {wide})")
    return out, dict(counts, **d, wide_chunk_ticks=wide)


def stage_gate(torch, model, prompt, got, want, what, margins):
    """The margin gate: ``got`` (prompt + tokens) equals ``want``, or at
    the first position where they differ the two tokens are within
    ``BF16_MARGIN`` in the model's own logits on ``want``'s prefix (rows
    that another path recomputed).  A divergence is appended to
    ``margins``; past the bound it raises."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: {got.shape} tokens, want "
                             f"{want.shape}")
    diff = np.nonzero(got != want)[0]
    if not len(diff):
        return True
    k = int(diff[0])
    row = {"what": what, "position": k - len(prompt),
           "margin": margin_at(torch, model, want[:k], int(got[k]),
                               int(want[k]))}
    margins.append(row)
    if row["margin"] > BF16_MARGIN:
        raise AssertionError(f"{what}: diverges with a logit margin above "
                             f"{BF16_MARGIN}: {row}")
    return False


def stage_exact(got, want, what):
    """The exact gate: runs whose tick schedule and row provenance are the
    same must give the same tokens."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (np.argwhere(got != want)[:4].tolist()
               if got.shape == want.shape else [got.shape, want.shape])
        raise AssertionError(f"{what}: not token-exact at {bad}")


def stage_alone(eng, prompts, new):
    """Each prompt served alone on ``eng``: the baselines."""
    out = []
    for p in prompts:
        r = eng.submit(p, new)
        eng.run_until_idle()
        out.append(r.result())
    eng.drop_prefix_cache()
    return out


def p50(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def stage_mixed(torch, eng, batch, inter, classes, streams=None):
    """The mixed load: the batch requests, ``STAGES_ARRIVAL`` ticks, then
    the interactive ones (their classes when ``classes``, else all
    default), run to the end; its readings."""
    nb, ni = STAGES_BATCH[2], STAGES_INTER[2]
    s0 = {k: int(eng._c[k].value)
          for k in ("preemptions", "preempt_replay_tokens", "tokens",
                    "prefix_hit_tokens")}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rb = [eng.submit(p, nb, priority="batch" if classes else None)
          for p in batch]
    for _ in range(STAGES_ARRIVAL):
        eng.step()
    if any(r.done for r in rb):
        raise AssertionError("stages: a batch request finished before the "
                             "interactive arrivals")
    ri = [eng.submit(p, ni, priority="interactive" if classes else None,
                     on_token=None if streams is None else streams[k].append)
          for k, p in enumerate(inter)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    d = {k: int(eng._c[k].value) - v for k, v in s0.items()}
    return {"batch": [r.result() for r in rb],
            "interactive": [r.result() for r in ri],
            "requests": rb + ri, "wall_s": wall,
            "tokens_per_s": d["tokens"] / wall,
            "ttft_p50_s": {"batch": p50([r.ttft_s for r in rb]),
                           "interactive": p50([r.ttft_s for r in ri])},
            "preempted_requests": sum(r._preempts > 0 for r in rb),
            **d}


def stage_replay_probe(torch, model, prompt, new):
    """Whether a row re-prefilled after a preemption is bit-identical to
    the row the first pass wrote: one request on a paged engine without a
    prefix cache (so its resume replays every row), its K and V rows read
    through its page table after 40 tokens, the stream preempted, and the
    same rows read again once the replay has consumed them; prompt rows
    (first written by prefill chunks) and generated rows (first written
    by width-1 decode steps) are counted apart."""
    eng = stage_engine(model, prefix_cache=False, **STAGES_ENGINE)
    req = eng.submit(prompt, new)
    while len(req.tokens) < 40:
        eng.step()

    def rows(n):
        i = next(k for k, s in enumerate(eng._slots) if s.req is req)
        pt = torch.tensor(eng._page_tables[i], device=DEV).long()
        j = torch.arange(n, device=DEV)
        page, off = pt[j // eng._page_size], j % eng._page_size
        return [(k[page, off].clone(), v[page, off].clone())
                for k, v in eng._caches]
    n = len(prompt) + len(req.tokens) - 1
    first = rows(n)
    with eng._lock:
        i = next(k for k, s in enumerate(eng._slots) if s.req is req)
        eng._preempt_slot_locked(i, time.perf_counter())
    while True:
        eng.step()
        slot = next(s for s in eng._slots if s.req is req)
        if slot.off >= len(slot.seq):
            break
    again = rows(n)
    same = torch.ones(n, dtype=torch.bool, device=DEV)
    max_diff = 0.0
    for (k0, v0), (k1, v1) in zip(first, again):
        eq = ((k0 == k1).flatten(1).all(1) & (v0 == v1).flatten(1).all(1))
        same &= eq
        max_diff = max(max_diff, float((k0.float() - k1.float()).abs().max()),
                       float((v0.float() - v1.float()).abs().max()))
    same = same.cpu().numpy()
    eng.run_until_idle()
    out = req.result()
    eng.shutdown()
    P = len(prompt)
    return out, {"rows": n, "prompt_rows_identical": int(same[:P].sum()),
                 "prompt_rows": P,
                 "generated_rows_identical": int(same[P:].sum()),
                 "generated_rows": n - P, "max_abs_diff": max_diff}


def phase_stages(torch, pa, qm, int8=None):
    """The engine's scheduler stages at the full width of GPT-2-small (bf16,
    N(0, 0.02) weights from a numpy seed) on the paged engine at the
    serving geometry (``STAGES_ENGINE``, ``STAGES_PAGES`` pages):

    - a mixed load (``STAGES_BATCH`` batch requests, ``STAGES_ARRIVAL``
      ticks, then ``STAGES_INTER`` interactive ones with ``on_token``
      streams): once all default (plain), twice with the classes.  Checks:
      preemptions > 0, the interactive TTFT p50 below the batch's, the two
      class runs token-exact against each other and the streams against
      the results, every stream against the same request alone exact or
      within the margin gate;
    - whether a replayed row is bit-identical to its first pass (probe);
    - 4 sessions x 3 turns against fresh submissions of the whole
      conversation (margin gate), resumes and hits counted;
    - ``defrag()`` moving pages, then a session turn exact against the
      same run without it;
    - a deadline abort mid-decode freeing its pages, the other streams and
      its own tokens exact against the run without the abort;
    - an ``auto_run`` burst from 4 threads ending in ``drain``, against
      the same requests step-driven (margin gate), tokens/s of both;
    - an n-gram spec engine (spec_k = 8) preempt-resume, against alone;
    - the int8 artifact (``int8``, saved and loaded here when None) on
      the dense engine with a preemption, against alone.
    K3's and K4's launches exact in every counted run (``stage_counted``),
    0 plain calls, no page left in use.  ``load_report()`` is printed."""
    import shutil
    import tempfile

    from paddle_hackathon_tpu_torch.inference import (DeadlineExceededError,
                                                      load_for_serving,
                                                      save_for_serving)
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.utils import load_jax_state

    t_phase = time.perf_counter()
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, device=DEV, dtype="bfloat16")
    load_jax_state(model, random_weights(model, seed=0))
    rng = np.random.RandomState(19)
    batch = [rng.randint(0, cfg.vocab_size, STAGES_BATCH[1]).astype(np.int32)
             for _ in range(STAGES_BATCH[0])]
    inter = [rng.randint(0, cfg.vocab_size, STAGES_INTER[1]).astype(np.int32)
             for _ in range(STAGES_INTER[0])]
    margins, report = [], {}

    def gate_all(what, got, prompts, want):
        exact = sum(stage_gate(torch, model, p, g, w, f"{what}[{k}]",
                               margins)
                    for k, (p, g, w) in enumerate(zip(prompts, got, want)))
        return {"token_exact": int(exact), "of": len(prompts)}

    def no_page_left(eng, what):
        eng.drop_sessions()
        eng.drop_prefix_cache()
        if eng.kv_pages_in_use:
            raise AssertionError(f"stages {what}: {eng.kv_pages_in_use} "
                                 f"pages left in use")

    # the baselines: every request alone
    alone_eng = stage_engine(model, **STAGES_ENGINE)
    alone_eng.generate(batch[0][:16], 4)                  # warm-up
    alone = {"batch": stage_alone(alone_eng, batch, STAGES_BATCH[2]),
             "interactive": stage_alone(alone_eng, inter, STAGES_INTER[2])}

    # (a) the mixed load: plain, then the classes twice
    eng = stage_engine(model, num_pages=STAGES_PAGES, **STAGES_ENGINE)
    runs = {}
    for name, classes in (("plain", False), ("classes", True),
                          ("classes_again", True)):
        streams = [[] for _ in inter]
        row, counts = stage_counted(
            torch, pa, qm, eng,
            lambda: stage_mixed(torch, eng, batch, inter, classes, streams),
            L)
        for r, s in zip(row["requests"][len(batch):], streams):
            if s != r.tokens + [None]:
                raise AssertionError(f"stages {name}: on_token stream "
                                     f"differs from the result")
        for group in ("batch", "interactive"):
            row[f"{group}_gate"] = gate_all(
                f"{name}.{group}", row[group],
                batch if group == "batch" else inter, alone[group])
        if name == "classes":
            report["load_report"] = eng.load_report()
        no_page_left(eng, name)
        del row["requests"]
        row["launches"] = counts
        runs[name] = row
    for group in ("batch", "interactive"):
        for a, b in zip(runs["classes"][group], runs["classes_again"][group]):
            stage_exact(a, b, f"two step-driven class runs ({group})")
    cls = runs["classes"]
    if not (cls["preemptions"] > 0 and cls["ttft_p50_s"]["interactive"]
            < cls["ttft_p50_s"]["batch"] and runs["plain"]["preemptions"]
            == 0):
        raise AssertionError(f"stages classes: preemptions "
                             f"{cls['preemptions']}, TTFT p50 "
                             f"{cls['ttft_p50_s']}")
    for row in runs.values():
        for group in ("batch", "interactive"):
            row.pop(group)
    report["mixed"] = runs
    del eng

    # (b) is a replayed row bit-identical to its first pass?
    out, report["replay_probe"] = stage_replay_probe(
        torch, model, batch[0], STAGES_BATCH[2])
    report["replay_probe"]["stream_exact"] = stage_gate(
        torch, model, batch[0], out, alone["batch"][0], "replay_probe",
        margins)

    # (c) 4 sessions x 3 turns against fresh whole-conversation requests
    eng = stage_engine(model, **STAGES_ENGINE)
    fresh = stage_engine(model, **STAGES_ENGINE)
    hist = [rng.randint(0, cfg.vocab_size, 64).astype(np.int32)
            for _ in range(4)]
    s0 = dict(eng.stats)
    sess = {"turns": []}
    for t in range(3):
        if t:
            hist = [np.concatenate(
                [h, rng.randint(0, cfg.vocab_size, 16).astype(np.int32)])
                for h in hist]

        def run_turn():
            reqs = [eng.submit(h, 32, session=f"s{k}")
                    for k, h in enumerate(hist)]
            eng.run_until_idle()
            return reqs
        got, counts = stage_counted(torch, pa, qm, eng, run_turn, L)
        want = [fresh.submit(h, 32) for h in hist]
        fresh.run_until_idle()
        fresh.drop_prefix_cache()
        sess["turns"].append(dict(gate_all(
            f"session_turn{t}", [r.result() for r in got], hist,
            [r.result() for r in want]), launches=counts))
        hist = [r.result() for r in got]
    sess.update({k: eng.stats[k] - s0[k] for k in (
        "session_resumes", "session_hit_tokens", "prefix_hit_tokens")})
    sess["retained_pages"] = eng.load_report()["sessions"]["retained_pages"]
    if sess["session_resumes"] != 8 or not sess["session_hit_tokens"]:
        raise AssertionError(f"stages sessions: {sess}")
    no_page_left(eng, "sessions")
    report["sessions"] = sess
    del eng, fresh

    # (d) defrag: the same session turn with and without a compaction
    outs, dfr = {}, {}
    for name in ("defrag", "without"):
        e = stage_engine(model, **STAGES_ENGINE)
        for sid, p in (("a", batch[1]), ("b", batch[2])):
            e.submit(p, 32, session=sid)
            e.run_until_idle()
        e.drop_prefix_cache()
        with e._lock:
            e._evict_session_locked("a", donate=False)
        if name == "defrag":
            pool = e._pool
            before = sorted(int(pool._ref[p]) for p in pool.allocated_ids())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            moved = e.defrag()
            torch.cuda.synchronize()
            dfr = {"pages_moved": moved,
                   "seconds": time.perf_counter() - t0,
                   "packed": pool.highest_allocated() == pool.allocated,
                   "refcounts_kept": before == sorted(
                       int(pool._ref[p]) for p in pool.allocated_ids())}
            if not (moved > 0 and dfr["packed"] and dfr["refcounts_kept"]):
                raise AssertionError(f"stages defrag: {dfr}")
        h = np.concatenate([e._sessions["b"].tokens, batch[3][:16]])
        r = e.submit(h, 32, session="b")
        e.run_until_idle()
        outs[name] = r.result()
        no_page_left(e, name)
        del e
    stage_exact(outs["defrag"], outs["without"], "defrag")
    report["defrag"] = dfr

    # (e) a deadline abort mid-decode, against the same run without it
    res = {}
    for name in ("abort", "without"):
        e = stage_engine(model, **STAGES_ENGINE)
        reqs = [e.submit(p, 64, deadline_s=1e6) for p in batch[:4]]
        for _ in range(6):
            e.step()
        used = e.kv_pages_in_use
        if name == "abort":
            reqs[0].deadline_s = 0.0
            e.step()
            freed = used - e.kv_pages_in_use
        e.run_until_idle()
        res[name] = [r.tokens for r in reqs]
        if name == "abort":
            if not (isinstance(reqs[0].error, DeadlineExceededError)
                    and freed > 0):
                raise AssertionError(f"stages deadline: {reqs[0].error!r},"
                                     f" {freed} pages freed")
            report["deadline"] = {"tokens_before_abort": len(reqs[0].tokens),
                                  "pages_freed": freed,
                                  "recent_aborts":
                                      e.introspect_requests()[
                                          "recent_aborts"]}
        no_page_left(e, name)
        del e
    n = len(res["abort"][0])
    stage_exact(res["abort"][0], res["without"][0][:n], "deadline prefix")
    for a, b in zip(res["abort"][1:], res["without"][1:]):
        stage_exact(a, b, "deadline others")

    # (f) an auto_run burst from 4 threads, against the same step-driven
    loop_eng = stage_engine(model, auto_run=True, **STAGES_ENGINE)
    step_eng = stage_engine(model, **STAGES_ENGINE)
    prompts = batch[4:12]
    for e in (loop_eng, step_eng):
        e.generate(batch[0][:16], 4, timeout=300)          # warm-up
    outs, errors = {}, []

    def burst():
        def client(k):
            # both of a client's requests in flight at once: one burst
            try:
                reqs = {j: loop_eng.submit(prompts[j], 64) for j in (k, k + 4)}
                for j, r in reqs.items():
                    r.wait(300)
                    outs[j] = r.result()
            except BaseException as exc:  # noqa: BLE001
                errors.append(exc)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(600)
        loop_eng.drain(timeout=300)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def stepped():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [step_eng.submit(p, 64) for p in prompts]
        step_eng.run_until_idle()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, [r.result() for r in reqs]
    wall_loop, loop_counts = stage_counted(torch, pa, qm, loop_eng, burst, L)
    (wall_step, step_outs), step_counts = stage_counted(
        torch, pa, qm, step_eng, stepped, L)
    if errors or loop_eng._running or not loop_eng.draining:
        raise AssertionError(f"stages auto_run: {errors}")
    report["auto_run"] = {
        "loop_tokens_per_s": 8 * 64 / wall_loop,
        "step_tokens_per_s": 8 * 64 / wall_step,
        "loop_wall_s": wall_loop, "step_wall_s": wall_step,
        "gate": gate_all("auto_run", [outs[j] for j in range(8)], prompts,
                         step_outs),
        "launches": {"loop": loop_counts, "step": step_counts}}
    for e in (loop_eng, step_eng):
        no_page_left(e, "auto_run")
        e.shutdown(timeout=60)
    del loop_eng, step_eng

    # (g) the n-gram spec engine, preempted and resumed
    spec_kw = dict(STAGES_ENGINE, spec_k=8)
    rep = np.tile(batch[5][:8], 8)
    e = stage_engine(model, num_pages=1 + 14 + 5, **spec_kw)
    e.generate(batch[0][:16], 4)                         # warm-up

    def spec_run():
        rb = e.submit(rep, STAGES_BATCH[2], priority="batch")
        for _ in range(6):
            e.step()
        ri = e.submit(inter[0], STAGES_INTER[2], priority="interactive")
        e.run_until_idle()
        return rb, ri
    (rb, ri), counts = stage_counted(torch, pa, qm, e, spec_run, L)
    quiet = stage_engine(model, **spec_kw)
    want = (stage_alone(quiet, [rep], STAGES_BATCH[2])
            + stage_alone(quiet, [inter[0]], STAGES_INTER[2]))
    report["spec"] = {
        "preempts": rb._preempts, "spec_ticks": counts["spec_ticks"],
        "spec_accepted": e.stats["spec_accepted"],
        "batch_exact": stage_gate(torch, model, rep, rb.result(), want[0],
                                  "spec.batch", margins),
        "launches": counts}
    stage_gate(torch, model, inter[0], ri.result(), want[1],
               "spec.interactive", margins)
    if not (rb._preempts and counts["spec_ticks"]):
        raise AssertionError(f"stages spec: {report['spec']}")
    no_page_left(e, "spec")
    del e, quiet

    # (h) the int8 artifact on the dense engine, with a preemption
    if int8 is None:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_stages_int8_")
        try:
            save_for_serving(model, tmp, quant="int8")
            int8 = load_for_serving(tmp, device=DEV)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    q_kw = dict(SERVE_INT8, max_slots=4)
    e = stage_engine(int8, **q_kw)
    e.generate(batch[0][:16], 4)                          # warm-up

    def int8_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rb = [e.submit(p, 64, priority="batch") for p in batch[:4]]
        for _ in range(3):
            e.step()
        ri = [e.submit(p, 64, priority="interactive") for p in inter[:2]]
        e.run_until_idle()
        torch.cuda.synchronize()
        return rb + ri, time.perf_counter() - t0
    (reqs, wall), counts = stage_counted(torch, pa, qm, e, int8_run, L)
    quiet = stage_engine(int8, **q_kw)
    want = stage_alone(quiet, batch[:4] + inter[:2], 64)
    qm_margins = []
    exact = sum(stage_gate(torch, int8, p, r.result(), w, f"int8[{k}]",
                           qm_margins)
                for k, (p, r, w) in enumerate(zip(batch[:4] + inter[:2],
                                                  reqs, want)))
    margins += qm_margins
    report["int8"] = {"tokens_per_s": 6 * 64 / wall, "wall_s": wall,
                      "preemptions": e.stats["preemptions"],
                      "token_exact": int(exact), "of": 6,
                      "ttft_p50_s": {
                          "batch": p50([r.ttft_s for r in reqs[:4]]),
                          "interactive": p50([r.ttft_s for r in reqs[4:]])},
                      "launches": counts}
    if not e.stats["preemptions"]:
        raise AssertionError(f"stages int8: {report['int8']}")
    del e, quiet, int8
    torch.cuda.empty_cache()
    emit({"phase": "stages", "model": "gpt2-small-en bf16",
          "engine": dict(STAGES_ENGINE, num_pages=STAGES_PAGES),
          "batch": STAGES_BATCH, "interactive": STAGES_INTER,
          "arrival_ticks": STAGES_ARRIVAL, "layers": L,
          "margin_limit": BF16_MARGIN, "divergences": margins,
          "seconds": time.perf_counter() - t_phase, **report})


# ---------------------------------------------------------------------------
# The deployment surface: the predictor, QAT, the fleet router, the native ABI
# ---------------------------------------------------------------------------

DEPLOY_PRED = (4, 1024)           # the predictor runs' batch x seq
DEPLOY_POOL = 4                   # PredictorPool size
DEPLOY_QAT = (8, 1024)            # the QAT fine-tune's batch x seq
DEPLOY_QAT_STEPS = 3
DEPLOY_QAT_SERVE = (8, 64, 128)   # requests, prompt, new tokens
DEPLOY_QAT_ENGINE = dict(max_slots=8, max_len=256, chunk=32)
DEPLOY_FLEET_ENGINE = dict(cache_mode="paged", max_slots=16, max_len=512,
                           page_size=16, chunk=32)
DEPLOY_FLEET_LOAD = (32, 64, 128)  # requests, prompt, new tokens
DEPLOY_SHARED = (16, 48)          # requests sharing a prefix, its length
DEPLOY_NATIVE = (4, 64, 32)       # client threads, prompt, new tokens
DEPLOY_NATIVE_ENGINE = (4, 256, 32)   # pht_engine_create's slots, len, chunk
# tests/test_quant_serving.py's int8-against-bf16 max-abs logit bound (set
# there on 12 positions of a 2-layer model; here K4 against its plain
# version through all 12 layers and 4,096 positions)
INT8_LOGIT_BOUND = 0.05
QAT_PROJ = (("attn", "qkv_proj"), ("attn", "out_proj"), ("mlp", "fc_in"),
            ("mlp", "fc_out"))
_DEPLOY_TL = threading.local()     # the fleet replica a loop thread drives


def deploy_counted(torch, fap, pa, qm, run):
    """``run()`` with K1's, K3's and K4's counts and the four plain
    versions' calls set to 0 just before and read just after."""
    names = {fap: ["flash_packed_fwd_ref", "flash_packed_bwd_ref"],
             pa: ["paged_attention_ref"], qm: ["quant_matmul_ref"]}
    plain = {n: 0 for ns in names.values() for n in ns}
    real = {mod: counting(mod, ns, plain) for mod, ns in names.items()}
    for counts in (fap.launches, pa.launches, pa.kernel_launches):
        for k in counts:
            counts[k] = 0
    qm.launches = 0
    try:
        out = run()
        torch.cuda.synchronize()
    finally:
        for mod, r in real.items():
            restore(mod, r)
    return out, {"k1": {k: n for k, n in fap.launches.items() if n},
                 "k3": {k: n for k, n in pa.kernel_launches.items() if n},
                 "k4": qm.launches, "plain_calls": sum(plain.values())}


def deploy_want(counts, want, what):
    if counts != dict(want, plain_calls=0):
        raise AssertionError(f"{what}: launches {counts}, want {want} and "
                             f"0 plain calls")


def logit_err(a, b):
    d = a.float() - b.float()
    return {"max": float(d.abs().max()), "rms": float(d.pow(2).mean().sqrt())}


def deploy_predictor(torch, fap, pa, qm, cfg, arrays, tmp):
    """(a): bf16 and int8 ``save_for_serving`` artifacts served by
    ``create_predictor`` at ``DEPLOY_PRED``: zero-copy and convenience runs,
    ``clone``, a ``PredictorPool``."""
    from paddle_hackathon_tpu_torch.inference import (Config, PredictorPool,
                                                      create_predictor,
                                                      save_for_serving)
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM
    from paddle_hackathon_tpu_torch.utils import load_jax_state
    L = cfg.num_layers
    model = bf16_model(torch, cfg, arrays)
    dirs = {"bf16": f"{tmp}/bf16", "int8": f"{tmp}/int8"}
    t0 = time.perf_counter()
    save_for_serving(model, dirs["bf16"])
    save_for_serving(model, dirs["int8"], quant="int8")
    t_save = time.perf_counter() - t0
    b, s = DEPLOY_PRED
    ids = np.random.RandomState(4).randint(0, cfg.vocab_size,
                                           (b, s)).astype(np.int32)
    with torch.inference_mode():
        own = model(torch.from_numpy(ids).to(DEV))
    del model
    # the f32 model on the same weights: what bf16 itself costs
    f32 = GPTForCausalLM(cfg, device=DEV)
    load_jax_state(f32, arrays)
    with torch.inference_mode():
        logits = {"f32": f32(torch.from_numpy(ids).to(DEV))}
    del f32
    torch.cuda.empty_cache()
    report, launches = {}, {"fwd": 0, "k4": 0}
    for kind in ("bf16", "int8"):
        t0 = time.perf_counter()
        pred = create_predictor(Config(dirs[kind]))
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        pred.get_input_handle("input_ids").copy_from_cpu(ids)
        pred.run()                                        # warm-up
        t0 = time.perf_counter()
        _, c = deploy_counted(torch, fap, pa, qm, pred.run)
        ms = 1e3 * (time.perf_counter() - t0)
        want = {"k1": {"fwd": L}, "k3": {},
                "k4": 4 * L if kind == "int8" else 0}
        deploy_want(c, want, f"predictor {kind} zero-copy run")
        launches["fwd"] += c["k1"]["fwd"]
        launches["k4"] += c["k4"]
        zc = pred.get_output_handle("fetch_0")._value
        (conv,), c2 = deploy_counted(torch, fap, pa, qm,
                                     lambda: pred.run([ids]))
        deploy_want(c2, want, f"predictor {kind} convenience run")
        launches["fwd"] += c2["k1"]["fwd"]
        launches["k4"] += c2["k4"]
        if not np.array_equal(conv, zc.float().cpu().numpy()):
            raise AssertionError(f"predictor {kind}: the convenience run's "
                                 f"logits differ from the zero-copy run's")
        clone = pred.clone()
        if clone._model is not pred._model:
            raise AssertionError("clone() copied the model")
        (cl,) = clone.run([ids])
        if not np.array_equal(cl, conv):
            raise AssertionError(f"predictor {kind}: the clone's logits "
                                 f"differ")
        if kind == "bf16" and not torch.equal(zc, own):
            raise AssertionError("predictor bf16: logits differ from the "
                                 "model's own forward")
        logits[kind] = zc
        if kind == "int8":
            # the same int8 model with K4's plain version on the card
            real = qm.quant_matmul_kernel
            qm.quant_matmul_kernel = qm.quant_matmul_ref
            try:
                with torch.inference_mode():
                    logits["int8_plain"] = pred._model(
                        torch.from_numpy(ids).to(DEV))
            finally:
                qm.quant_matmul_kernel = real
        report[kind] = {"load_s": t_load, "run_ms": ms, "launches": c,
                        "shape": list(zc.shape)}
        pred.clear_intermediate_tensor()
        del pred, clone, conv, cl
    errs = {f"{a}_vs_{b}": logit_err(logits[a], logits[b])
            for a, b in (("int8", "bf16"), ("int8", "int8_plain"),
                         ("int8_plain", "bf16"), ("bf16", "f32"),
                         ("int8", "f32"))}
    del logits, own
    torch.cuda.empty_cache()
    # K4 against its plain version through the whole int8 model, held to
    # the int8 bound; int8 against bf16 no further from bf16 than the
    # plain version's own quantization error plus that bound
    if not (errs["int8_vs_int8_plain"]["max"] < INT8_LOGIT_BOUND
            and errs["int8_vs_bf16"]["max"] <= errs["int8_plain_vs_bf16"][
                "max"] + INT8_LOGIT_BOUND):
        raise AssertionError(f"int8 logits: {errs}, bound "
                             f"{INT8_LOGIT_BOUND}")
    # the pool: what one predictor's load allocates, and its clones less
    # than 1% of the weight bytes on top
    def allocated(make):
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated()
        out = make()
        torch.cuda.synchronize()
        return out, torch.cuda.memory_allocated() - m0
    one, one_bytes = allocated(lambda: create_predictor(Config(dirs["int8"])))
    weight = sum(t.numel() * t.element_size()
                 for t in one._model.parameters())
    del one
    torch.cuda.empty_cache()
    pool, pool_bytes = allocated(
        lambda: PredictorPool(Config(dirs["int8"]), size=DEPLOY_POOL))
    main = pool.retrieve(0)
    if len({id(pool.retrieve(i)._model) for i in range(DEPLOY_POOL)}) != 1 \
            or not pool_bytes - one_bytes < 0.01 * weight:
        raise AssertionError(f"PredictorPool({DEPLOY_POOL}) allocated "
                             f"{pool_bytes} bytes, one predictor "
                             f"{one_bytes}, weights {weight}")
    outs = []
    for i in range(DEPLOY_POOL):
        p = pool.retrieve(i)
        (o,), c = deploy_counted(torch, fap, pa, qm, lambda p=p: p.run([ids]))
        deploy_want(c, {"k1": {"fwd": L}, "k3": {}, "k4": 4 * L},
                    f"pool member {i}")
        launches["fwd"] += c["k1"]["fwd"]
        launches["k4"] += c["k4"]
        p.clear_intermediate_tensor()
        outs.append(o)
    if not all(np.array_equal(o, outs[0]) for o in outs):
        raise AssertionError("the pool's members disagree")
    del pool, main, outs
    torch.cuda.empty_cache()
    emit({"phase": "deploy_predictor", "model": "gpt2-small-en",
          "batch": b, "seq": s, "artifact_save_s": t_save,
          "logit_errors": errs, "int8_bound": INT8_LOGIT_BOUND, "pool_size": DEPLOY_POOL,
          "pool_bytes": pool_bytes, "one_predictor_bytes": one_bytes,
          "weight_bytes": weight,
          "clones_over_weight_bytes": (pool_bytes - one_bytes) / weight,
          **report})
    return dirs, launches


def deploy_qat(torch, fap, pa, qm, cfg, arrays, tmp):
    """(b): the QAT fine-tune (48 ``QuantizedLinear``s, channel-wise
    weight scales), ``convert_to_weight_only``, the artifact round trip and
    the dense int8 engine."""
    from paddle_hackathon_tpu_torch.inference import (load_for_serving,
                                                      save_for_serving)
    from paddle_hackathon_tpu_torch.nn.quant import (QuantizedLinear,
                                                     convert_to_weight_only)
    from paddle_hackathon_tpu_torch.optimizer import AdamW
    L = cfg.num_layers
    model = bf16_model(torch, cfg, arrays)
    wrapped = {}
    for i, blk in enumerate(model.gpt.blocks):
        for part, name in QAT_PROJ:
            parent = getattr(blk, part)
            q = QuantizedLinear(getattr(parent, name),
                                weight_quantize_type="channel_wise_abs_max")
            setattr(parent, name, q)
            wrapped[f"gpt.blocks.{i}.{part}.{name}"] = (parent, name)
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=list(model.parameters()),
                weight_decay=0.01)
    b, s = DEPLOY_QAT
    rng = np.random.RandomState(5)
    ids = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(DEV)
    labels = torch.from_numpy(rng.randint(0, cfg.vocab_size, (b, s))).to(DEV)

    def steps():
        losses = []
        for _ in range(DEPLOY_QAT_STEPS):
            loss = model.loss(ids, labels)
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(loss.detach())
        return losses
    t0 = time.perf_counter()
    losses, c = deploy_counted(torch, fap, pa, qm, steps)
    wall = time.perf_counter() - t0
    n = DEPLOY_QAT_STEPS * L
    deploy_want(c, {"k1": {"fwd": n, "dkdv": n, "dq": n}, "k3": {}, "k4": 0},
                "QAT steps")
    losses = [float(x) for x in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"QAT losses not finite: {losses}")
    k1 = dict(c["k1"])
    model.eval()
    learned = {k: getattr(p, n)._fake_quant_weight.scale.clone()
               for k, (p, n) in wrapped.items()}
    weights = {k: getattr(p, n).weight.detach().clone()
               for k, (p, n) in wrapped.items()}
    if convert_to_weight_only(model) != len(wrapped):
        raise AssertionError("convert_to_weight_only did not convert every "
                             "QuantizedLinear")
    steps_off = 0.0
    for k, (p, n) in wrapped.items():
        lay = getattr(p, n)
        want_s = torch.clamp_min(learned[k] / 127.0, 1e-9)
        if not torch.equal(lay.weight_scale.view(torch.int32),
                           want_s.view(torch.int32)):
            raise AssertionError(f"{k}: weight_scale is not the learned "
                                 f"absmax / 127 bit for bit")
        w = weights[k]
        grid = torch.clamp(torch.round(w.float() / want_s[None, :]),
                           -127, 127)
        if not torch.equal(lay.weight.float(), grid):
            raise AssertionError(f"{k}: the int8 weights are off the "
                                 f"fake-quant grid")
        # the training forward's bf16 fake-quant of the same weight, in
        # grid steps from the served dequantization (recorded)
        sb = learned[k].to(torch.bfloat16)[None, :]
        fq = torch.clamp(torch.round(w / sb * 127.0), -127, 127) / 127.0 * sb
        deq = lay.weight.float() * lay.weight_scale[None, :]
        steps_off = max(steps_off, float(((deq - fq.float()).abs()
                                          / want_s[None, :]).max()))
    del weights, opt, ids, labels
    torch.cuda.empty_cache()
    save_for_serving(model, f"{tmp}/qat")
    del model
    served = load_for_serving(f"{tmp}/qat")
    nreq, plen, new = DEPLOY_QAT_SERVE
    prompts = [rng.randint(0, cfg.vocab_size, plen).astype(np.int32)
               for _ in range(nreq)]
    eng = stage_engine(served, **DEPLOY_QAT_ENGINE)
    eng.generate(prompts[0][:16], 2)                      # warm-up

    def serve():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, new) for p in prompts]
        eng.run_until_idle()
        torch.cuda.synchronize()
        return reqs, time.perf_counter() - t0
    (reqs, swall), counts = stage_counted(torch, pa, qm, eng, serve, L)
    with torch.inference_mode():
        want = served.generate(torch.from_numpy(np.stack(prompts)).to(DEV),
                               max_new_tokens=new,
                               temperature=0.0).cpu().numpy()
    margins = []
    exact = sum(stage_gate(torch, served, p, r.result(), w, f"qat[{i}]",
                           margins)
                for i, (p, r, w) in enumerate(zip(prompts, reqs, want)))
    eng.shutdown(timeout=60)
    del eng, served
    torch.cuda.empty_cache()
    emit({"phase": "deploy_qat", "model": "gpt2-small-en bf16",
          "quantized_linears": len(wrapped), "batch": b, "seq": s,
          "steps": DEPLOY_QAT_STEPS, "wall_s": wall, "losses": losses,
          "k1_launches": k1, "bf16_fake_quant_max_steps_off": steps_off,
          "engine": DEPLOY_QAT_ENGINE, "requests": nreq, "prompt": plen,
          "new_tokens": new, "tokens_per_s": nreq * new / swall,
          "token_exact": int(exact), "of": nreq, "divergences": margins,
          "margin_limit": BF16_MARGIN, "launches": counts})
    return k1, counts["k4"]


def fleet_engine(model, **kw):
    """An ``auto_run`` paged replica whose chunk forwards are recorded as
    wide or not (``stage_engine``) and whose loop threads carry its id."""
    eng = stage_engine(model, **dict(DEPLOY_FLEET_ENGINE, auto_run=True,
                                     **kw))
    real = eng._loop

    def loop(_real=real, _id=eng.engine_id):
        _DEPLOY_TL.engine = _id
        return _real()
    eng._loop = loop
    return eng


def fleet_idle(engs, timeout=60.0):
    """Wait until no replica's loop runs (its last tick has committed)."""
    end = time.monotonic() + timeout
    for e in engs:
        while True:
            with e._lock:
                if not e._running:
                    break
            if time.monotonic() > end:
                raise AssertionError(f"{e.engine_id}: loop still running")
            time.sleep(0.005)


def fleet_counted(torch, pa, qm, engs, run, layers):
    """``run()`` with K3's counts and the plain versions' calls set to 0
    just before and read just after, and ``paged_attention``'s calls
    counted per replica (by the loop thread that made them): each
    replica's calls equal what its ticks need (a call a layer for each
    chunk tick and for each of a decode tick's ``decode_window`` steps),
    none outside a replica's loop, the K3 kernels' launches the sum (the
    wide chunk ticks on ``tiles_tc``, every other call on ``split``), no
    K4 launch and no plain call."""
    calls, lock = {}, threading.Lock()
    real = pa.paged_attention

    def counted(*a, **kw):
        eid = getattr(_DEPLOY_TL, "engine", None)
        with lock:
            calls[eid] = calls.get(eid, 0) + 1
        return real(*a, **kw)
    s0 = {e.engine_id: (dict(e.stats), len(e.stage_widths)) for e in engs}
    pa.paged_attention = counted
    try:
        def whole():
            out = run()
            fleet_idle(engs)
            return out
        out, counts = counted_launches(torch, pa, qm, whole)
    finally:
        pa.paged_attention = real
    per, k3 = {}, {"tiles_tc": 0, "split": 0}
    for e in engs:
        st0, w0 = s0[e.engine_id]
        d = {k: e.stats[k] - st0[k] for k in ("chunk_ticks", "decode_ticks")}
        wide = sum(e.stage_widths[w0:])
        want = layers * (d["chunk_ticks"] + e._decode_window
                         * d["decode_ticks"])
        per[e.engine_id] = dict(calls=calls.get(e.engine_id, 0), want=want,
                                **d, wide_chunk_ticks=wide)
        k3["tiles_tc"] += layers * wide
        k3["split"] += want - layers * wide
    k3 = {k: n for k, n in k3.items() if n}
    if (any(r["calls"] != r["want"] for r in per.values())
            or calls.get(None, 0) or counts["k3"] != k3 or counts["k4"]
            or counts["plain_calls"]):
        raise AssertionError(f"fleet launches {counts} per replica {per} "
                             f"(outside a loop: {calls.get(None, 0)}), "
                             f"want K3 {k3}, no K4 and 0 plain calls")
    return out, dict(counts, replicas=per)


def fleet_pages_home(engs):
    """Every page home on every replica (prefix caches dropped)."""
    for e in engs:
        e.drop_prefix_cache()
        if e.kv_pages_in_use:
            raise AssertionError(f"{e.engine_id}: {e.kv_pages_in_use} pages "
                                 f"left in use")


def fleet_check(torch, model, prompts, frs, want, what, margins):
    """Each completed fleet request against one engine alone (the margin
    gate); returns how many were token-exact."""
    return sum(stage_gate(torch, model, p, fr.result(), w,
                          f"{what}[{i}]", margins)
               for i, (p, fr, w) in enumerate(zip(prompts, frs, want))
               if fr.error is None)


def fleet_readings(frs, wall, new):
    """tokens/s and TTFT p50 (router submit to first token) of a run."""
    ttft = [fr._req.t_first - fr._t_submit for fr in frs
            if fr.error is None and fr._req.t_first is not None]
    done = sum(fr.error is None for fr in frs)
    return {"wall_s": wall, "tokens_per_s": done * new / wall,
            "ttft_p50_s": p50(ttft), "completed": done}


def deploy_fleet(torch, pa, qm, cfg, arrays):
    """(c): two paged replicas behind ``FleetRouter`` at
    ``DEPLOY_FLEET_ENGINE``, ``DEPLOY_FLEET_LOAD`` (the first
    ``DEPLOY_SHARED[0]`` requests share a prefix): one engine alone (the
    reference and the baseline readings), a plain fleet run, a failover
    drill, a drain under load, affinity against round-robin."""
    from paddle_hackathon_tpu_torch.inference import (FleetRouter,
                                                      StreamInterruptedError)
    from paddle_hackathon_tpu_torch.observability import faults
    L = cfg.num_layers
    n, plen, new = DEPLOY_FLEET_LOAD
    nshared, slen = DEPLOY_SHARED
    rng = np.random.RandomState(6)
    shared = rng.randint(0, cfg.vocab_size, slen).astype(np.int32)
    prompts = [np.concatenate([shared, rng.randint(
        0, cfg.vocab_size, plen - slen).astype(np.int32)])
        for _ in range(nshared)]
    prompts += [rng.randint(0, cfg.vocab_size, plen).astype(np.int32)
                for _ in range(n - nshared)]
    # a model object a replica, on the same weights
    models = [bf16_model(torch, cfg, arrays) for _ in range(2)]
    for m in models:                                       # warm-up
        e = fleet_engine(m)
        e.generate(prompts[-1][:16], 2)
        e.shutdown(timeout=60)
    report, margins, launches = {}, [], {"tiles_tc": 0, "split": 0}

    def add(counts):
        for k in launches:
            launches[k] += counts["k3"].get(k, 0)

    # one engine alone: the reference tokens and the baseline readings
    solo = fleet_engine(models[0])

    def solo_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [solo.submit(p, new) for p in prompts]
        for r in reqs:
            r.wait(300)
        return reqs, time.perf_counter() - t0
    (reqs, wall), counts = fleet_counted(torch, pa, qm, [solo], solo_run, L)
    add(counts)
    want = [r.result() for r in reqs]
    report["one_engine"] = {
        "wall_s": wall, "tokens_per_s": n * new / wall,
        "ttft_p50_s": p50([r.ttft_s for r in reqs]), "launches": counts}
    fleet_pages_home([solo])
    solo.shutdown(timeout=60)

    def fleet_run(router, subset=None, first=None):
        """Submit ``first`` (waited) then the rest of the load through
        ``router``; wait for all."""
        idx = list(range(n)) if subset is None else subset
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frs = {}
        if first is not None:
            frs[first] = router.submit(prompts[first], new)
            frs[first].wait(300)
        for i in idx:
            if i not in frs:
                frs[i] = router.submit(prompts[i], new)
        for fr in frs.values():
            if not fr.wait(300):
                raise AssertionError("a fleet request hung")
        return [frs[i] for i in idx], time.perf_counter() - t0

    # plain fleet run
    engs = [fleet_engine(m) for m in models]
    router = FleetRouter(engs, backoff_s=0.01)
    (frs, wall), counts = fleet_counted(
        torch, pa, qm, engs, lambda: fleet_run(router), L)
    add(counts)
    if any(fr.error is not None for fr in frs):
        raise AssertionError(f"fleet: {[fr.error for fr in frs]}")
    exact = fleet_check(torch, models[0], prompts, frs, want, "fleet",
                        margins)
    report["fleet"] = dict(fleet_readings(frs, wall, new),
                           token_exact=int(exact), launches=counts,
                           placed={e.engine_id: sum(fr.replica == e.engine_id
                                                    for fr in frs)
                                   for e in engs})
    fleet_pages_home(engs)
    router.shutdown(timeout=60)

    # the failover drill: wave A (the unshared prompts) started, then
    # serving.tick[<replica 0>] fails every tick and wave B arrives
    engs = [fleet_engine(m) for m in models]
    router = FleetRouter(engs, backoff_s=0.01, breaker_failures=1)
    dead = engs[0].engine_id
    point = f"serving.tick[{dead}]"

    def drill():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wave_a = {i: router.submit(prompts[i], new)
                  for i in range(nshared, n)}
        end = time.monotonic() + 120
        while not all(len(fr.tokens) for fr in wave_a.values()):
            if time.monotonic() > end:
                raise AssertionError("failover: wave A did not start")
            time.sleep(0.002)
        faults.arm_point(point, "prob", p=1.0)
        wave_b = {i: router.submit(prompts[i], new) for i in range(nshared)}
        frs = {**wave_a, **wave_b}
        for fr in frs.values():
            if not fr.wait(300):
                raise AssertionError("failover: a request hung")
        return [frs[i] for i in range(n)], time.perf_counter() - t0
    # the dead replica's loops end in the injected fault: counted here
    # instead of printed
    hook, killed = threading.excepthook, []

    def quiet(args):
        if isinstance(args.exc_value, faults.InjectedFault):
            killed.append(args.thread.name)
        else:
            hook(args)
    threading.excepthook = quiet
    try:
        (frs, wall), counts = fleet_counted(torch, pa, qm, engs, drill, L)
    finally:
        faults.disarm()
        threading.excepthook = hook
    add(counts)
    interrupted = [i for i, fr in enumerate(frs) if fr.error is not None]
    for i in interrupted:
        if not (isinstance(frs[i].error, StreamInterruptedError)
                and frs[i].tokens and i >= nshared):
            raise AssertionError(f"failover: request {i} failed with "
                                 f"{frs[i].error!r}")
    moved = [i for i, fr in enumerate(frs) if fr.retries and not fr.error]
    if not interrupted or not moved or any(
            frs[i].replica == dead for i in moved):
        raise AssertionError(f"failover: interrupted {interrupted}, failed "
                             f"over {moved}")
    exact = fleet_check(torch, models[0], prompts, frs, want, "failover",
                        margins)
    report["failover"] = dict(fleet_readings(frs, wall, new),
                              token_exact=int(exact),
                              interrupted=len(interrupted),
                              failed_over=len(moved),
                              dead_replica_loops=len(killed),
                              launches=counts)
    fleet_pages_home(engs)
    router.shutdown(timeout=60)

    # a drain under load: replica 0 drained while the load runs
    engs = [fleet_engine(m) for m in models]
    router = FleetRouter(engs, backoff_s=0.01)

    def drain_run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frs = [router.submit(p, new) for p in prompts]
        router.drain(engs[0].engine_id, timeout=300)
        for fr in frs:
            if not fr.wait(300):
                raise AssertionError("drain: a request hung")
        return frs, time.perf_counter() - t0
    (frs, wall), counts = fleet_counted(torch, pa, qm, engs, drain_run, L)
    add(counts)
    lost = [i for i, fr in enumerate(frs) if fr.error is not None]
    if lost or router.replica_names() != [engs[1].engine_id]:
        raise AssertionError(f"drain: lost {lost}, replicas "
                             f"{router.replica_names()}")
    exact = fleet_check(torch, models[0], prompts, frs, want, "drain",
                        margins)
    report["drain"] = dict(fleet_readings(frs, wall, new),
                           token_exact=int(exact), lost=0, launches=counts,
                           drained_served=sum(fr.replica == engs[0].engine_id
                                              for fr in frs))
    fleet_pages_home(engs)
    router.shutdown(timeout=60)

    # affinity against round-robin: one shared-prefix request first, then
    # the rest of the load
    ratios = {}
    for policy in ("least_loaded", "round_robin"):
        engs = [fleet_engine(m) for m in models]
        router = FleetRouter(engs, backoff_s=0.01, policy=policy)
        (frs, wall), counts = fleet_counted(
            torch, pa, qm, engs, lambda: fleet_run(router, first=0), L)
        add(counts)
        if any(fr.error is not None for fr in frs):
            raise AssertionError(f"{policy}: {[fr.error for fr in frs]}")
        exact = fleet_check(torch, models[0], prompts, frs, want, policy,
                            margins)
        ratios[policy] = [e.stats["prefix_hit_rate"] for e in engs]
        report[policy] = dict(fleet_readings(frs, wall, new),
                              token_exact=int(exact), launches=counts,
                              prefix_hit_rate=ratios[policy])
        fleet_pages_home(engs)
        router.shutdown(timeout=60)
    if not max(ratios["least_loaded"]) > max(ratios["round_robin"]):
        raise AssertionError(f"affinity: prefix-hit ratios {ratios}")
    del models, engs, router
    torch.cuda.empty_cache()
    emit({"phase": "deploy_fleet", "model": "gpt2-small-en bf16",
          "replicas": 2, "engine": DEPLOY_FLEET_ENGINE, "requests": n,
          "prompt": plen, "new_tokens": new, "shared_prefix": DEPLOY_SHARED,
          "margin_limit": BF16_MARGIN, "divergences": margins,
          "k3_launches": launches, **report})
    return launches


NATIVE_CLIENT_CC = r"""
// A C++ serving client with no Python in its source: threads call
// pht_engine_generate concurrently on one engine, then the error paths.
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

extern "C" {
int32_t pht_serving_init(const char* repo_dir);
void* pht_engine_create(const char*, int32_t, int32_t, int32_t);
int64_t pht_engine_generate(void*, const int32_t*, int32_t, int32_t,
                            int32_t*, int64_t, double);
const char* pht_predictor_last_error();
void pht_engine_destroy(void*);
}

// argv: repo, model_dir, threads, prompt_len, new, vocab, slots, len, chunk
int main(int argc, char** argv) {
  if (argc != 10) return 2;
  int T = std::atoi(argv[3]), P = std::atoi(argv[4]), N = std::atoi(argv[5]);
  int V = std::atoi(argv[6]);
  if (pht_serving_init(argv[1]) != 0) {
    std::fprintf(stderr, "init: %s\n", pht_predictor_last_error());
    return 3;
  }
  void* eng = pht_engine_create(argv[2], std::atoi(argv[7]),
                                std::atoi(argv[8]), std::atoi(argv[9]));
  if (!eng) {
    std::fprintf(stderr, "create: %s\n", pht_predictor_last_error());
    return 4;
  }
  // thread k's prompt: (k * 7919 + i * 31 + 1) % V, i < P
  std::vector<std::vector<int32_t>> outs(T, std::vector<int32_t>(P + N));
  std::vector<int64_t> ns(T, 0);
  std::vector<std::thread> threads;
  for (int k = 0; k < T; k++) {
    threads.emplace_back([&, k] {
      std::vector<int32_t> prompt(P);
      for (int i = 0; i < P; i++) prompt[i] = (k * 7919 + i * 31 + 1) % V;
      ns[k] = pht_engine_generate(eng, prompt.data(), P, N, outs[k].data(),
                                  P + N, k == 0 ? 0.0 : 600.0);
    });
  }
  for (auto& t : threads) t.join();
  for (int k = 0; k < T; k++) {
    if (ns[k] < 0) {
      std::fprintf(stderr, "generate %d: %s\n", k,
                   pht_predictor_last_error());
      return 5;
    }
    std::printf("client %d:", k);
    for (int64_t i = 0; i < ns[k]; i++) std::printf(" %d", outs[k][i]);
    std::printf("\n");
  }
  int64_t s = pht_engine_generate(eng, outs[0].data(), P, N, outs[0].data(),
                                  3, 600.0);
  std::printf("gen_small %lld: %s\n", (long long)s,
              pht_predictor_last_error());
  int64_t b = pht_engine_generate(nullptr, outs[0].data(), P, N,
                                  outs[0].data(), P + N, 600.0);
  std::printf("gen_bad %lld: %s\n", (long long)b, pht_predictor_last_error());
  std::string missing = std::string(argv[2]) + ".missing";
  void* e2 = pht_engine_create(missing.c_str(), 2, 64, 4);
  std::printf("engine_missing %d: %s\n", e2 == nullptr,
              pht_predictor_last_error());
  pht_engine_destroy(eng);
  return 0;
}
"""


def deploy_native(torch, cfg, model_dir, tmp):
    """(d): the shim and a C++ client built with g++; ``DEPLOY_NATIVE``
    threads generate concurrently through ``pht_engine_generate`` from the
    int8 artifact on the card, against the Python engine on the same
    artifact; the error paths return their strings."""
    import os

    from paddle_hackathon_tpu_torch import native
    from paddle_hackathon_tpu_torch.inference import load_for_serving
    t0 = time.perf_counter()
    shim = native.build_serving_shim()
    src = f"{tmp}/client.cc"
    with open(src, "w") as f:
        f.write(NATIVE_CLIENT_CC)
    client = f"{tmp}/client"
    subprocess.run(["g++", "-O2", "-std=c++17", src,
                    *native.client_link_flags(shim), "-o", client],
                   check=True, capture_output=True, text=True)
    t_build = time.perf_counter() - t0
    T, P, N = DEPLOY_NATIVE
    slots, max_len, chunk = DEPLOY_NATIVE_ENGINE
    repo = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run(
        [client, repo, model_dir, str(T), str(P), str(N),
         str(cfg.vocab_size), str(slots), str(max_len), str(chunk)],
        capture_output=True, text=True, timeout=600, env=native.client_env())
    t_client = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"native client exited {res.returncode}: "
                             f"{res.stderr[-3000:]}")
    lines = dict(ln.split(": ", 1) if ": " in ln else (ln.rstrip(":"), "")
                 for ln in res.stdout.splitlines())
    prompts = [np.asarray([(k * 7919 + i * 31 + 1) % cfg.vocab_size
                           for i in range(P)], np.int32) for k in range(T)]
    model = load_for_serving(model_dir)
    eng = stage_engine(model, max_slots=slots, max_len=max_len, chunk=chunk)
    reqs = [eng.submit(p, N) for p in prompts]
    eng.run_until_idle()
    margins = []
    exact = sum(stage_gate(
        torch, model, p, np.asarray([int(t) for t in
                                     lines[f"client {k}"].split()]),
        r.result(), f"native[{k}]", margins)
        for k, (p, r) in enumerate(zip(prompts, reqs)))
    errors = {k: lines.get(k) for k in ("gen_small -2", "gen_bad -3",
                                        "engine_missing 1")}
    if (errors["gen_small -2"] != "output buffer too small"
            or errors["gen_bad -3"] != "bad engine handle"
            or not errors["engine_missing 1"]):
        raise AssertionError(f"native error paths: {res.stdout[-2000:]}")
    eng.shutdown(timeout=60)
    del eng, model
    torch.cuda.empty_cache()
    emit({"phase": "deploy_native", "artifact": "gpt2-small-en int8",
          "shim": shim.name, "build_s": t_build, "client_s": t_client,
          "threads": T, "prompt": P, "new_tokens": N,
          "engine": dict(max_slots=slots, max_len=max_len, chunk=chunk),
          "token_exact": int(exact), "of": T, "divergences": margins,
          "margin_limit": BF16_MARGIN, "error_strings": errors})


def phase_deploy(torch, fap, pa, qm):
    """The deployment surface at the full width of GPT-2-small (bf16,
    N(0, 0.02) weights from a numpy seed): (a) the predictor, (b) QAT,
    (c) the fleet router, (d) the native ABI.  Returns the main-path
    launches: K1's (the predictor and the QAT steps), K4's (the int8
    predictor and the QAT engine) and K3's (the fleet runs)."""
    import shutil
    import tempfile

    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    t_phase = time.perf_counter()
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    arrays = random_weights(GPTForCausalLM(cfg, device="cpu"), seed=0)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_deploy_")
    try:
        dirs, pred = deploy_predictor(torch, fap, pa, qm, cfg, arrays, tmp)
        qat_k1, qat_k4 = deploy_qat(torch, fap, pa, qm, cfg, arrays, tmp)
        k3 = deploy_fleet(torch, pa, qm, cfg, arrays)
        deploy_native(torch, cfg, dirs["int8"], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = {"k1": {"fwd": pred["fwd"] + qat_k1["fwd"],
                       "dkdv": qat_k1["dkdv"], "dq": qat_k1["dq"]},
                "k4": pred["k4"] + qat_k4, "k3": k3}
    emit({"phase": "deploy", "seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches


# ---------------------------------------------------------------------------
# The Paddle dygraph surface: GPT-2-small trained through Tensor / tape /
# Layer, beside the sharded step; the op table on the card
# ---------------------------------------------------------------------------

DYGRAPH_SHAPE = dict(b=8, s=1024)
DYGRAPH_STEPS = 7                 # 2 warm-up + 5 timed
DYGRAPH_WARMUP = 2
# the largest relative gap allowed between the two paths' f32 loss at any
# step when they are not equal bit for bit
DYGRAPH_REL_GAP = 2e-3
DYGRAPH_PLACE = "cuda:0"          # where to_tensor with no place must land


def dygraph_batches(vocab):
    rng = np.random.RandomState(2)
    b, s = DYGRAPH_SHAPE["b"], DYGRAPH_SHAPE["s"]
    return [(rng.randint(0, vocab, (b, s)).astype(np.int32),
             rng.randint(0, vocab, (b, s)).astype(np.int32))
            for _ in range(DYGRAPH_STEPS)]


def dygraph_series(torch, run_step):
    """Run ``run_step(i)`` for the phase's steps with CUDA events around
    each; returns (records, ms per timed step on the device timeline, the
    timed wall seconds, the timed steps' peak memory)."""
    recs, events, t0 = [], [], None
    for i in range(DYGRAPH_STEPS):
        if i == DYGRAPH_WARMUP:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        recs.append(run_step(i, e1))
        events.append((e0, e1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = [a.elapsed_time(b) for a, b in events[DYGRAPH_WARMUP:]]
    return recs, float(np.mean(ms)), wall, torch.cuda.max_memory_allocated()


def dygraph_op_sweep(torch, paddle):
    """Every ``OP_TABLE`` op on CUDA ``Tensor``s against the same op on
    CPU ``Tensor``s from the same numpy inputs (the cases of
    ``tests/test_torch_op_cases.py``)."""
    import os
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    import test_torch_op_cases as oc
    cpu = oc.Side(paddle, paddle.ops.OP_TABLE, "cpu")
    gpu = oc.Side(paddle, paddle.ops.OP_TABLE, "gpu")
    passed, failed = 0, []
    t0 = time.perf_counter()
    for name in sorted(paddle.ops.OP_TABLE):
        try:
            oc.run_case(name, oc.ALL[name], cpu, gpu)
            if name in oc.EXTRA:
                oc.run_case(name, oc.EXTRA[name], cpu, gpu)
            passed += 1
        except Exception as e:  # noqa: BLE001 -- every failure is listed
            failed.append({"op": name, "error": repr(e)[:300]})
    paddle.set_device("gpu")
    return {"ops": len(paddle.ops.OP_TABLE), "passed": passed,
            "failed": failed, "seconds": time.perf_counter() - t0,
            "rtol": oc.RTOL, "atol": oc.ATOL}


def phase_dygraph(torch, fap):
    """GPT-2-small (bf16 parameters, b=8, s=1024) trained 7 Adam steps
    through the Paddle idiom and through ``make_sharded_train_step`` from
    the same weights and batches; then the op sweep.  Returns K1's
    launches by kernel over the idiom's steps."""
    import paddle_hackathon_tpu_torch as paddle
    from paddle_hackathon_tpu_torch.core import device as pdevice
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.nn import functional as F
    from paddle_hackathon_tpu_torch.nn.functional import \
        fused_softmax_ce_rows
    from paddle_hackathon_tpu_torch.parallel import make_sharded_train_step
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    # the default place is the card
    pdevice._current = None
    probe = paddle.to_tensor(np.arange(3, dtype=np.float32))
    placed = str(probe._value.device)
    if placed != DYGRAPH_PLACE or paddle.get_device() != "gpu:0":
        raise AssertionError(f"to_tensor with no place landed on {placed}")
    paddle.set_device("gpu")
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    arrays = random_weights(GPTForCausalLM(cfg, device="cpu"), seed=0)
    batches = dygraph_batches(cfg.vocab_size)
    L = cfg.num_layers

    # (a) the Paddle idiom
    model = bf16_model(torch, cfg, arrays)
    opt = paddle.optimizer.Adam(learning_rate=1e-4, beta2=0.95,
                                parameters=model.parameters(),
                                grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    grads0 = {}

    def idiom_step(i, done):
        ids_np, lab_np = batches[i]
        ids = paddle.to_tensor(ids_np)
        logits = model(ids)
        loss = F.cross_entropy(logits, paddle.to_tensor(lab_np))
        loss.backward()
        if i == 0:
            grads0.update({n: p.grad.cpu()
                           for n, p in model.named_parameters()})
        opt.step()
        opt.clear_grad()
        done.record()
        with torch.no_grad():   # the sharded step's loss formula, f32
            l32 = fused_softmax_ce_rows(
                logits._value, torch.from_numpy(lab_np).to(DEV)).mean()
        return loss, l32

    plain = {"flash_packed_fwd_ref": 0, "flash_packed_bwd_ref": 0}
    real = counting(fap, plain, plain)
    try:
        for k in fap.launches:
            fap.launches[k] = 0
        recs, idiom_ms, idiom_wall, idiom_peak = dygraph_series(
            torch, idiom_step)
        launches = dict(fap.launches)
    finally:
        restore(fap, real)
    idiom_bf16 = [float(l_) for l_, _ in recs]
    idiom_f32 = [l32 for _, l32 in recs]
    gnorm0 = float(sum(g.float().square().sum() for g in grads0.values())
                   .sqrt())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idiom_step(1, torch.cuda.Event())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    idiom_prof = profile_summary(torch, prof, wall)
    del model, opt, recs, prof
    torch.cuda.empty_cache()

    # (b) the sharded step, same weights and batches
    model = bf16_model(torch, cfg, arrays)
    step, state = make_sharded_train_step(model, learning_rate=1e-4,
                                          grad_clip_norm=1.0)
    ids0 = torch.from_numpy(batches[0][0]).to(DEV).long()
    lab0 = torch.from_numpy(batches[0][1]).to(DEV).long()
    fused_softmax_ce_rows(model(ids0), lab0).mean().backward()
    grads_equal = all(not bits_differ(torch, p.grad.cpu(), grads0[n])
                      for n, p in model.named_parameters())
    model.zero_grad(set_to_none=True)
    del grads0

    def sharded_step(i, done):
        nonlocal state
        state, loss = step(state, *batches[i])
        done.record()
        return loss

    sharded, sharded_ms, sharded_wall, sharded_peak = dygraph_series(
        torch, sharded_step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *batches[0])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sharded_prof = profile_summary(torch, prof, wall)
    del model, step, state, prof
    torch.cuda.empty_cache()

    # the two series
    first = next((i for i, (a, b) in enumerate(zip(idiom_f32, sharded))
                  if bits_differ(torch, a, b)), None)
    idiom_f32 = [float(x) for x in idiom_f32]
    sharded = [float(x) for x in sharded]
    gaps = [abs(a - b) / abs(b) for a, b in zip(idiom_f32, sharded)]
    cause = None
    if first == 0:
        cause = "the forward: the first step's losses differ"
    elif first is not None and not grads_equal:
        cause = "the backward: the first step's gradients differ in bits"
    elif first is not None and gnorm0 > 1.0:
        cause = ("the clip (global norm %.4g > 1.0 at step 0): "
                 "ClipGradByGlobalNorm sums the squared norms in "
                 "parameters() order and scales each bf16 gradient in f32 "
                 "before rounding it; the sharded step sums in sorted-name "
                 "order and multiplies the bf16 gradients by the scale "
                 "rounded to bf16" % gnorm0)
    elif first is not None:
        cause = "unexplained: the gradients agree and the clip is idle"

    sweep = dygraph_op_sweep(torch, paddle)
    need = DYGRAPH_STEPS * L
    out = {"phase": "dygraph", "nvidia_smi": smi, "model": "gpt2-small-en "
           "bf16", "batch": DYGRAPH_SHAPE["b"], "seq": DYGRAPH_SHAPE["s"],
           "steps": DYGRAPH_STEPS, "warmup": DYGRAPH_WARMUP,
           "to_tensor_default_place": placed,
           "idiom": {"loss_bf16": idiom_bf16, "loss_f32": idiom_f32,
                     "ms_per_step": idiom_ms, "timed_wall_s": idiom_wall,
                     "peak_memory_gb": idiom_peak / 1e9,
                     "profile": idiom_prof},
           "sharded": {"loss_f32": sharded, "ms_per_step": sharded_ms,
                       "timed_wall_s": sharded_wall,
                       "peak_memory_gb": sharded_peak / 1e9,
                       "profile": sharded_prof},
           "bit_equal": first is None, "first_differing_step": first,
           "rel_gaps": gaps, "rel_gap_limit": DYGRAPH_REL_GAP,
           "first_step_grads_bit_equal": grads_equal,
           "first_step_grad_norm": gnorm0, "reorders": cause,
           "k1_launches": launches, "k1_launches_expected_each": need,
           "plain_k1_calls": plain, "op_sweep": sweep,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    if any(n != need for n in launches.values()) or any(plain.values()):
        raise AssertionError(f"dygraph: K1 launches {launches} != {need} "
                             f"each, or plain calls {plain}")
    if not all(np.isfinite(idiom_f32 + sharded)):
        raise AssertionError("dygraph: non-finite loss")
    if max(gaps) > DYGRAPH_REL_GAP:
        raise AssertionError(f"dygraph: loss series differ by {max(gaps)} "
                             f"> {DYGRAPH_REL_GAP} ({cause})")
    if sweep["failed"]:
        raise AssertionError(f"dygraph: ops failed on the card: "
                             f"{[f['op'] for f in sweep['failed']]}")
    pdevice._current = None
    return launches


# ---------------------------------------------------------------------------
# Model.fit and the input pipeline: GPT-2-small trained through hapi.Model
# fed by the DataLoader's native staging ring, beside the dygraph idiom
# ---------------------------------------------------------------------------

FIT_STEPS = DYGRAPH_STEPS         # the eager fit and K = 1 against the idiom
FIT_K_STEPS = 8                   # K = 4 against K = 1 over two supersteps
FIT_TIMED = (1, DYGRAPH_STEPS - 1)  # events after step 1 .. after step 6:
#                                   steps 3-7 (1-indexed) between them
FIT_EVAL_BATCHES = 2
# the planted fault's copy delay: a sleep kernel on the copy stream before
# each slot's copy (about 10 ms at the card's clock), so a slot released
# before its copy's event is overwritten while the copy waits
FIT_COPY_DELAY_CYCLES = 20_000_000
FIT_PLACE = "cuda:0"              # where the DataLoader's batches must land


def fit_rows(vocab, n):
    """The phase's ``n`` batches as dataset rows: the dygraph phase's
    batches (the same numpy stream), one row per sequence."""
    rng = np.random.RandomState(2)
    b, s = DYGRAPH_SHAPE["b"], DYGRAPH_SHAPE["s"]
    pairs = [(rng.randint(0, vocab, (b, s)).astype(np.int32),
              rng.randint(0, vocab, (b, s)).astype(np.int32))
             for _ in range(n)]
    return (np.concatenate([p[0] for p in pairs]),
            np.concatenate([p[1] for p in pairs]))


def fit_checksum_weights(torch, shape, device):
    n = int(np.prod(shape))
    return (torch.arange(n, device=device, dtype=torch.int64) % 9973
            + 1).reshape(shape)


class FitRecorder:
    """A loader wrapper that records, for every batch it hands to
    ``Model.fit``, a position-weighted checksum of both arrays (on the
    card, read after the fit) and the type of the iterator that ran."""

    def __init__(self, torch, loader, weights):
        self.torch, self.loader, self.w = torch, loader, weights
        self.sums, self.iterators = [], []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        self.iterators.append(type(it).__name__)
        for ids, labels in it:
            self.sums.append(self.torch.stack([
                (ids._value.long() * self.w).sum(),
                (labels._value.long() * self.w).sum()]))
            yield ids, labels

    def host_sums(self):
        return [tuple(int(v) for v in s.cpu().tolist()) for s in self.sums]


def fit_expected_sums(rows, b):
    ids, labels = rows
    w = (np.arange(ids[:b].size, dtype=np.int64) % 9973 + 1).reshape(
        ids[:b].shape)
    return [(int((ids[i:i + b].astype(np.int64) * w).sum()),
             int((labels[i:i + b].astype(np.int64) * w).sum()))
            for i in range(0, len(ids), b)]


class FitSteps:
    """Callback: each step's loss, and a CUDA event at the end of every
    step (recorded when the loop hands the step to the callbacks)."""

    def __init__(self, torch, base):
        self.torch, self.losses, self.events = torch, [], []
        self.base = base

    def make(self):
        rec = self

        class _Cb(self.base):
            def on_train_batch_end(self, step, logs=None):
                rec.losses.append(logs["loss"])
                ev = rec.torch.cuda.Event(enable_timing=True)
                ev.record()
                rec.events.append(ev)
        return _Cb()

    def series(self):
        return [float(v) for v in self.losses]

    def ms_per_step(self, a=FIT_TIMED[0], b=FIT_TIMED[1]):
        self.torch.cuda.synchronize()
        return self.events[a].elapsed_time(self.events[b]) / (b - a)


def fit_loader_integrity(torch, pdl, make_loader, expected, planted):
    """Run the buffered loader alone over the rows with every slot's copy
    delayed on the copy stream; with ``planted`` each slot goes back to the
    ring as soon as its copy is queued (before the copy's event).  Returns
    how many batches' checksums differ from the rows'."""
    real_copy = pdl._BufferedPrefetchIter._copy_to_card
    real_release = pdl._BufferedPrefetchIter._release_when_copied

    def delayed_copy(self, view):
        with torch.cuda.stream(self._copy_stream):
            torch.cuda._sleep(FIT_COPY_DELAY_CYCLES)
        return real_copy(self, view)

    def early_release(self, ev, slot):
        self.ring.release(slot)

    pdl._BufferedPrefetchIter._copy_to_card = delayed_copy
    if planted:
        pdl._BufferedPrefetchIter._release_when_copied = early_release
    try:
        rec = make_loader()
        for _ in rec:
            pass
        got = rec.host_sums()
    finally:
        pdl._BufferedPrefetchIter._copy_to_card = real_copy
        pdl._BufferedPrefetchIter._release_when_copied = real_release
    bad = sum(1 for a, b in zip(got, expected) if a != b)
    return {"batches": len(got), "iterator": rec.iterators,
            "mismatched_batches": bad + abs(len(got) - len(expected))}


def phase_fit(torch, fap):
    """GPT-2-small (bf16, b=8, s=1024) trained through ``Model.fit`` from a
    ``DataLoader(num_workers=2, use_buffer_reader=True)`` over the dygraph
    phase's weights and batches: the eager fit against the dygraph idiom
    (bit for bit), the K-step trainer at K = 1 against the eager fit and
    K = 4 against K = 1; the loader's checksums with and without a planted
    early slot release; evaluate, predict, save/load and summary.  Returns
    K1's launches by kernel over the fits."""
    import gc
    import os
    import shutil
    import tempfile

    import paddle_hackathon_tpu_torch as paddle
    from paddle_hackathon_tpu_torch.core import device as pdevice
    from paddle_hackathon_tpu_torch.core import native
    from paddle_hackathon_tpu_torch.io import dataloader as pdl
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.nn import functional as F
    from paddle_hackathon_tpu_torch.observability import metrics as obs
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    if not native.available():
        raise AssertionError("fit: the native runtime did not build")
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    arrays = random_weights(GPTForCausalLM(cfg, device="cpu"), seed=0)
    L, b = cfg.num_layers, DYGRAPH_SHAPE["b"]
    rows = fit_rows(cfg.vocab_size, FIT_K_STEPS)
    expected = fit_expected_sums(rows, b)

    class Rows(paddle.io.Dataset):
        def __len__(self):
            return len(rows[0])

        def __getitem__(self, i):
            return rows[0][i], rows[1][i]

    # the default place is the card: the loader's batches land there
    pdevice._current = None
    weights = fit_checksum_weights(torch, (b, DYGRAPH_SHAPE["s"]), DEV)

    def make_loader():
        return FitRecorder(torch, paddle.io.DataLoader(
            Rows(), batch_size=b, shuffle=False, num_workers=2,
            use_buffer_reader=True), weights)

    probe = next(iter(paddle.io.DataLoader(Rows(), batch_size=b,
                                           num_workers=2)))
    placed = str(probe[0]._value.device)
    if placed != FIT_PLACE:
        raise AssertionError(f"fit: the DataLoader's batch landed on "
                             f"{placed}")
    del probe

    def optimizer(model):
        return paddle.optimizer.Adam(
            learning_rate=1e-4, beta2=0.95, parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    # (a) the dygraph idiom, as in the dygraph phase, in this process
    model = bf16_model(torch, cfg, arrays)
    opt = optimizer(model)
    idiom_events, idiom = [], []
    for i in range(FIT_STEPS):
        ids = paddle.to_tensor(rows[0][i * b:(i + 1) * b])
        loss = F.cross_entropy(model(ids), paddle.to_tensor(
            rows[1][i * b:(i + 1) * b]))
        loss.backward()
        opt.step()
        opt.clear_grad()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        idiom_events.append(ev)
        idiom.append(float(loss))
    torch.cuda.synchronize()
    idiom_ms = idiom_events[FIT_TIMED[0]].elapsed_time(
        idiom_events[FIT_TIMED[1]]) / (FIT_TIMED[1] - FIT_TIMED[0])
    # the weights after the last step, kept on the card to compare bits
    final = {"idiom": {k: v.detach().clone()
                       for k, v in model.state_dict().items()}}
    del model, opt
    torch.cuda.empty_cache()

    def fit_run(steps, **kw):
        # one input (the ids): predict's batches carry the labels too
        model = paddle.Model(bf16_model(torch, cfg, arrays),
                             inputs=["input_ids"], labels=["labels"])
        model.prepare(optimizer=optimizer(model.network),
                      loss=paddle.nn.CrossEntropyLoss())
        cb = FitSteps(torch, paddle.callbacks.Callback)
        rec = make_loader()
        model.fit(rec, epochs=1, num_iters=steps, verbose=0,
                  callbacks=[cb.make()], **kw)
        return model, cb, rec

    plain = {"flash_packed_fwd_ref": 0, "flash_packed_bwd_ref": 0}
    real = counting(fap, plain, plain)
    runs = {}
    try:
        for k in fap.launches:
            fap.launches[k] = 0
        for name, steps, kw in (
                ("eager", FIT_STEPS, dict(jit_compile=False)),
                ("k1_7", FIT_STEPS, dict(jit_compile=True,
                                         steps_per_execution=1)),
                ("k1", FIT_K_STEPS, dict(jit_compile=True,
                                         steps_per_execution=1)),
                ("k4", FIT_K_STEPS, dict(jit_compile=True,
                                         steps_per_execution=4))):
            before = dict(fap.launches)
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            model, cb, rec = fit_run(steps, **kw)
            final[name] = {k: v.detach().clone() for k, v in
                           model.network.state_dict().items()}
            runs[name] = {
                "model": model, "losses": cb.series(),
                "ms": cb.ms_per_step(*((3, 7) if name == "k4"
                                       else FIT_TIMED)),
                "compiled": model._fit_used_compiled,
                "iterators": rec.iterators, "sums": rec.host_sums(),
                "launches": {k: fap.launches[k] - before[k]
                             for k in before},
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
                "held_before_gb": base / 1e9}
            if name != "eager":
                del model
                runs[name].pop("model")
                torch.cuda.empty_cache()
        launches = dict(fap.launches)
    finally:
        restore(fap, real)
    reg = obs.get_registry()
    wait = reg.histogram("input_wait_seconds", "", unit="s").labels(
        site="device_prefetch")
    gauges = {name: reg.gauge(name, "").labels(path="hapi_compiled")._value
              for name in ("train_mfu", "train_tokens_per_sec")}
    phases = {ph: reg.gauge("train_phase_seconds_per_step", "").labels(
        path="hapi_compiled", phase=ph)._value
        for ph in ("dispatch", "host_wait", "device")}

    eager = runs["eager"]
    fit_model = eager.pop("model")
    first_k1 = runs["k1_7"]["losses"]
    k1_vs_eager = [abs(a - b_) / abs(b_)
                   for a, b_ in zip(first_k1, eager["losses"])]

    def same_weights(a, b_):
        return sorted(final[a]) == sorted(final[b_]) and all(
            torch.equal(final[a][k], final[b_][k]) for k in final[a])

    weights_equal = {"eager_vs_idiom": same_weights("eager", "idiom"),
                     "k1_vs_eager": same_weights("k1_7", "eager"),
                     "k4_vs_k1": same_weights("k4", "k1")}
    del final
    torch.cuda.empty_cache()

    # (b) the loader alone: control, then the planted early release
    control = fit_loader_integrity(torch, pdl, make_loader, expected, False)
    planted = fit_loader_integrity(torch, pdl, make_loader, expected, True)

    # the device-to-host half of io/transfer.py on the card
    from paddle_hackathon_tpu_torch.io import finish_d2h, start_d2h
    src = torch.randn(b, 3, 64, device=DEV).to(torch.bfloat16)
    d2h = finish_d2h(start_d2h({"x": src, "y": (paddle.to_tensor(
        rows[0][:b]), 7)}))
    d2h_ok = (np.array_equal(d2h["x"], src.cpu().view(torch.int16).numpy()
                             .view(np.uint16))
              and np.array_equal(d2h["y"][0], rows[0][:b])
              and d2h["y"][1] == 7)

    # (c) evaluate and predict on 2 batches, counted
    eval_loader = make_loader()
    for k in fap.launches:
        fap.launches[k] = 0
    real = counting(fap, plain, plain)
    try:
        ev_logs = fit_model.evaluate(eval_loader, num_iters=FIT_EVAL_BATCHES,
                                     verbose=0)
        preds = fit_model.predict(make_loader(), num_iters=FIT_EVAL_BATCHES)
        eval_launches = dict(fap.launches)
    finally:
        restore(fap, real)
    pred_ok = (len(preds) == FIT_EVAL_BATCHES
               and tuple(preds[0][0].shape) == (b, DYGRAPH_SHAPE["s"],
                                                cfg.vocab_size))

    # (d) save, load into a fresh model (other weights), equal
    tmp = tempfile.mkdtemp(prefix="fit_save_")
    try:
        fit_model.save(os.path.join(tmp, "gpt2"), training=False)
        fresh = paddle.Model(bf16_model(torch, cfg, random_weights(
            GPTForCausalLM(cfg, device="cpu"), seed=1)),
            inputs=["input_ids"], labels=["labels"])
        fresh.prepare(loss=paddle.nn.CrossEntropyLoss())
        fresh.load(os.path.join(tmp, "gpt2"))
        a_sd, b_sd = fit_model.network.state_dict(), \
            fresh.network.state_dict()
        loaded_equal = sorted(a_sd) == sorted(b_sd) and all(
            torch.equal(a_sd[k], b_sd[k]) for k in a_sd)
        fresh_logs = fresh.evaluate(make_loader(),
                                    num_iters=FIT_EVAL_BATCHES, verbose=0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del fresh

    # (e) summary against the parameters (the tied embedding once)
    import contextlib
    import io as _io
    with contextlib.redirect_stdout(_io.StringIO()):
        totals = fit_model.summary()
    n_params = sum(p.numel() for _, p in
                   fit_model.network.named_parameters())

    # (f) one profiled eager fit step
    ids = paddle.to_tensor(rows[0][:b])
    labels = paddle.to_tensor(rows[1][:b])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_model.train_batch([ids], [labels])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof_sum = profile_summary(torch, prof, wall)
    del fit_model, prof
    torch.cuda.empty_cache()

    need = {"eager": FIT_STEPS * L, "k1_7": FIT_STEPS * L,
            "k1": FIT_K_STEPS * L, "k4": FIT_K_STEPS * L}
    out = {"phase": "fit", "nvidia_smi": smi,
           "model": "gpt2-small-en bf16", "batch": b,
           "seq": DYGRAPH_SHAPE["s"], "loader_default_place": placed,
           "ring": {"iterator": sorted({i for r in runs.values()
                                        for i in r["iterators"]}),
                    "slots": max(4, 2 * 2 * 2),
                    "slot_bytes": pdl._BufferedPrefetchIter.slot_bytes,
                    "batch_bytes": int(rows[0][:b].nbytes
                                       + rows[1][:b].nbytes)},
           "idiom": {"loss": idiom, "ms_per_step": idiom_ms},
           **{n: {k: r[k] for k in ("losses", "ms", "compiled", "launches",
                                    "peak_gb", "held_before_gb")}
              for n, r in runs.items()},
           "eager_equals_idiom": eager["losses"] == idiom,
           "k1_equals_eager": first_k1 == eager["losses"],
           "k1_vs_eager_rel_gaps": k1_vs_eager,
           "k4_equals_k1": runs["k4"]["losses"] == runs["k1"]["losses"],
           "final_weights_bit_equal": weights_equal,
           "checksums_equal": {n: r["sums"] == expected[:len(r["sums"])]
                               for n, r in runs.items()},
           "loader_control": control, "loader_planted_early_release":
           planted, "d2h_equal": d2h_ok,
           "input_wait_seconds": {"p50": wait.quantile(0.5),
                                  "max": wait.max, "count": wait.count},
           "gauges": gauges, "phase_seconds_per_step": phases,
           "k1_launches": launches, "plain_k1_calls": plain,
           "eval": {"loss": ev_logs.get("loss"),
                    "launches": eval_launches, "predict_ok": pred_ok},
           "save_load": {"weights_equal": loaded_equal,
                         "eval_loss": fresh_logs.get("loss")},
           "summary": {**totals, "named_parameters": n_params},
           "profile_eager_step": prof_sum,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    fails = []
    if out["ring"]["iterator"] != ["_BufferedPrefetchIter"]:
        fails.append(f"iterators {out['ring']['iterator']}")
    if not (out["eager_equals_idiom"] and weights_equal["eager_vs_idiom"]):
        fails.append("the eager fit differs from the idiom")
    if not (out["k1_equals_eager"] and weights_equal["k1_vs_eager"]) and \
            max(k1_vs_eager) > DYGRAPH_REL_GAP:
        fails.append(f"K=1 differs from eager by {max(k1_vs_eager)}")
    if not (out["k4_equals_k1"] and weights_equal["k4_vs_k1"]):
        fails.append("K=4 differs from K=1")
    if eager["compiled"] or not all(runs[n]["compiled"]
                                    for n in ("k1_7", "k1", "k4")):
        fails.append("a fit took the other path")
    if not all(out["checksums_equal"].values()):
        fails.append(f"loader checksums {out['checksums_equal']}")
    if not d2h_ok:
        fails.append("start_d2h / finish_d2h differ from the tensors")
    if control["mismatched_batches"] or not \
            planted["mismatched_batches"]:
        fails.append(f"loader check: control {control}, planted {planted}")
    for n, r in runs.items():
        if any(v != need[n] for v in r["launches"].values()):
            fails.append(f"{n}: K1 launches {r['launches']} != {need[n]}")
    if any(plain.values()):
        fails.append(f"plain K1 calls {plain}")
    if eval_launches["dkdv"] or eval_launches["dq"] or \
            eval_launches["fwd"] != 2 * FIT_EVAL_BATCHES * L or not pred_ok:
        fails.append(f"eval/predict: launches {eval_launches}, "
                     f"predict {pred_ok}")
    if not loaded_equal or fresh_logs.get("loss") != ev_logs.get("loss"):
        fails.append(f"save/load: weights {loaded_equal}, eval "
                     f"{fresh_logs} vs {ev_logs}")
    if totals["total_params"] != n_params:
        fails.append(f"summary {totals} vs {n_params}")
    series = idiom + [v for r in runs.values() for v in r["losses"]]
    if not all(np.isfinite(series)):
        fails.append("non-finite loss")
    if fails:
        raise AssertionError("fit: " + "; ".join(fails))
    return launches


# ---------------------------------------------------------------------------
# The encoder: ERNIE-3.0-base MLM pretraining on K1's non-causal path
# ---------------------------------------------------------------------------

ERNIE_SHAPE = dict(b=64, s=512)           # bench.py's bench_ernie row
ERNIE_ATTN = dict(b=64, s=512, H=12, D=64)
ERNIE_STEPS = 10
ERNIE_TIMED = (1, ERNIE_STEPS - 1)        # events after step 2 .. after
#                                           step 10: steps 3-10 between them
ERNIE_REL_TOL = 1e-2                      # step 0's loss, flash vs plain
ERNIE_HEADS_B = 8
ERNIE_HEADS_TOL = 2e-2                    # masked rows against full logits
ERNIE_FT = dict(b=16, s=128, steps=5, eval_batches=2)
ERNIE_BN = dict(rows=32, b=8, tol=1e-5)


def ernie_batch(b, s, vocab, seed=0):
    """``bench_ernie``'s batch: ids, and 15% of the positions masked, their
    flat indices padded to a multiple of 512 (pad labels -1)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (b, s)).astype(np.int32)
    lab = rng.randint(0, vocab, (b, s))
    m = rng.rand(b, s) < 0.15
    flat = np.where(m.reshape(-1))[0]
    k = -(-int(b * s * 0.16) // 512) * 512
    if len(flat) > k:
        raise AssertionError(f"{len(flat)} masked positions > K = {k}")
    pos = np.zeros(k, np.int32)
    pos[:len(flat)] = flat
    labels = np.full(k, -1, np.int64)
    labels[:len(flat)] = lab.reshape(-1)[flat]
    return ids, pos, labels, len(flat)


def ernie_loss_fn(model, params, buffers, batch, rng):
    """``bench_ernie``'s loss: the masked rows' cross entropy
    (``fused_softmax_ce_rows``), pad rows (label -1) counted zero."""
    import torch
    from paddle_hackathon_tpu_torch.nn.functional import \
        fused_softmax_ce_rows
    from paddle_hackathon_tpu_torch.nn.layer import functional_call
    (ids, pos), labels = batch
    logits = functional_call(model, params, (ids,),
                             kwargs={"masked_positions": pos},
                             buffers=buffers)[0]
    keep = labels >= 0
    rows = fused_softmax_ce_rows(logits, labels.clamp_min(0))
    rows = torch.where(keep, rows, torch.zeros_like(rows))
    return rows.sum() / keep.sum().clamp_min(1)


def ernie_bn_fit(torch, paddle, place, state):
    """``Model.fit`` (default ``jit_compile``) on ``Sequential(Linear,
    BatchNorm1D, Linear)`` from ``state`` on ``place``: the running stats
    after its steps, whether it fell back to the eager loop, and the
    reason ``jit_compile=True`` gives."""
    nn = paddle.nn
    paddle.set_device(place)
    rng = np.random.RandomState(0)
    x = rng.randn(ERNIE_BN["rows"], 10).astype(np.float32)
    y = (x.sum(1) > 0).astype(np.int64)

    class Toy(paddle.io.Dataset):
        def __len__(self):
            return len(x)

        def __getitem__(self, i):
            return x[i], y[i]

    net = nn.Sequential(nn.Linear(10, 8), nn.BatchNorm1D(8),
                        nn.Linear(8, 2))
    net.set_state_dict(state)
    m = paddle.Model(net)
    m.prepare(optimizer=paddle.optimizer.Adam(learning_rate=1e-2,
                                              parameters=net.parameters()),
              loss=nn.CrossEntropyLoss())
    m.fit(Toy(), epochs=1, batch_size=ERNIE_BN["b"], shuffle=False,
          verbose=0)
    try:
        m.fit(Toy(), epochs=1, batch_size=ERNIE_BN["b"], verbose=0,
              jit_compile=True)
        reason = None
    except ValueError as e:
        reason = str(e)
    stats = {k: v.detach().float().cpu().numpy()
             for k, v in net[1].state_dict().items() if k.startswith("_")}
    return stats, m._fit_used_compiled, reason


def phase_ernie(torch, fap):
    """ERNIE-3.0-base (12 x 768, 12 heads, vocab 40,000, type vocab 4,
    bf16 parameters, dropout 0) MLM pretraining with ``bench_ernie``'s
    recipe through ``make_sharded_train_step``: K1 non-causal at the
    encoder's attention against its plain version, timed beside SDPA and
    its bound; 10 steps through K1 (12 launches a step each) against 10
    from the same weights through the plain composition; the
    masked-positions head against the full logits under a padding mask (no
    K1); ``ErnieForSequenceClassification`` fine-tuned through
    ``Model.fit`` and evaluated; a BatchNorm network's eager fit against
    the CPU.  Returns the kernel rows and the training run's K1 launches."""
    import torch.nn.functional as TF
    from torch.profiler import ProfilerActivity, profile

    import paddle_hackathon_tpu_torch as paddle
    from paddle_hackathon_tpu_torch import models
    from paddle_hackathon_tpu_torch.core import device as pdevice
    from paddle_hackathon_tpu_torch.parallel import make_sharded_train_step
    from paddle_hackathon_tpu_torch.utils import load_jax_state
    t_phase = time.perf_counter()
    smi = nvidia_smi()
    fails = []
    torch.backends.cuda.matmul.allow_tf32 = False

    # (1) K1 non-causal at the encoder's attention
    kernel = k1_times(torch, fap, TF, ERNIE_ATTN, False, seed=102,
                      control=True)
    t_kernel = time.perf_counter() - t_phase

    # (2) 10 steps through K1 against 10 through the plain composition
    def config(**kw):
        return models.ernie_config("ernie-3.0-base-zh",
                                   hidden_dropout_prob=0.0,
                                   attention_dropout_prob=0.0, **kw)
    cfg = config()
    L = cfg.num_layers
    arrays = random_weights(models.BertForPretraining(cfg, device=DEV),
                            seed=0)
    torch.cuda.empty_cache()
    b, s = ERNIE_SHAPE["b"], ERNIE_SHAPE["s"]
    ids, pos, labels, n_masked = ernie_batch(b, s, cfg.vocab_size)
    batch = ((torch.from_numpy(ids).to(DEV), torch.from_numpy(pos).to(DEV)),
             torch.from_numpy(labels).to(DEV))

    def train(use_flash):
        model = models.BertForPretraining(
            config(use_flash_attention=use_flash), device=DEV)
        load_jax_state(model, arrays)
        step, state = make_sharded_train_step(
            model, learning_rate=1e-4, grad_clip_norm=1.0,
            param_dtype="bfloat16", loss_fn=ernie_loss_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, events = [], []
        for _ in range(ERNIE_STEPS):
            state, loss = step(state, *batch)
            losses.append(loss)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
        torch.cuda.synchronize()
        a, z = ERNIE_TIMED
        return {"model": model, "step": step, "state": state,
                "losses": [float(v) for v in losses],
                "ms": events[a].elapsed_time(events[z]) / (z - a),
                "peak_gb": torch.cuda.max_memory_allocated() / 1e9}

    plain = {"flash_packed_fwd_ref": 0, "flash_packed_bwd_ref": 0}
    real = counting(fap, plain, plain)
    try:
        for k in fap.launches:
            fap.launches[k] = 0
        flash = train(True)
        launches = dict(fap.launches)
    finally:
        restore(fap, real)
    model, step, state = flash.pop("model"), flash.pop("step"), \
        flash.pop("state")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof_sum = profile_summary(torch, prof, wall)
    k1_device_ms = sum(
        device_us(e) for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA")
        and "flash_tc" in e.key) / 1e3
    del prof, step, state
    torch.cuda.empty_cache()
    ref = train(False)
    ref.pop("model"), ref.pop("step"), ref.pop("state")
    torch.cuda.empty_cache()
    rel0 = abs(flash["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    diffs = [abs(a - c) for a, c in zip(flash["losses"], ref["losses"])]
    tokens_s = b * s / flash["ms"] * 1e3

    # (3) the masked-positions head against the full logits, under a
    # padding mask on half the rows: the plain composition, no K1
    model.eval()
    hb = ERNIE_HEADS_B
    hids, hpos, _, _ = ernie_batch(hb, s, cfg.vocab_size, seed=1)
    mask = np.ones((hb, s), np.int32)
    mask[hb // 2:, s // 2:] = 0
    hids_t, hpos_t = torch.from_numpy(hids).to(DEV), \
        torch.from_numpy(hpos).to(DEV).long()
    mask_t = torch.from_numpy(mask).to(DEV)
    for k in fap.launches:
        fap.launches[k] = 0
    with torch.no_grad():
        full, _ = model(hids_t, attention_mask=mask_t)
        rows, _ = model(hids_t, attention_mask=mask_t,
                        masked_positions=hpos_t)
        want = full.reshape(-1, full.shape[-1]).index_select(0, hpos_t)
        heads_bitwise = bool(torch.equal(rows, want))
        heads_err = float((rows.float() - want.float()).abs().max())
        heads_finite = bool(torch.isfinite(full).all())
    heads_launches = dict(fap.launches)
    heads = {"batch": hb, "padded_rows": hb - hb // 2,
             "logits_dtype": str(full.dtype), "bitwise": heads_bitwise,
             "max_abs_err": heads_err, "tol": ERNIE_HEADS_TOL,
             "k1_launches": heads_launches, "finite": heads_finite}
    del full, rows, want, model
    torch.cuda.empty_cache()

    # (4) ErnieForSequenceClassification through Model.fit, then evaluate
    ft = ERNIE_FT
    rng = np.random.RandomState(3)
    ft_ids = rng.randint(0, cfg.vocab_size,
                         (ft["b"] * ft["steps"], ft["s"])).astype(np.int32)
    ft_y = rng.randint(0, 2, (ft["b"] * ft["steps"],)).astype(np.int64)

    class Rows(paddle.io.Dataset):
        def __len__(self):
            return len(ft_ids)

        def __getitem__(self, i):
            return ft_ids[i], ft_y[i]

    pdevice._current = None        # the default place: the card
    net = models.ErnieForSequenceClassification(cfg, num_classes=2,
                                                device=DEV)
    load_jax_state(net, random_weights(net, seed=1))
    with torch.no_grad():
        for p in net.parameters():
            p.data = p.data.to(torch.bfloat16)
    fit_model = paddle.Model(net, inputs=["input_ids"], labels=["labels"])
    fit_model.prepare(
        optimizer=paddle.optimizer.Adam(learning_rate=1e-4,
                                        parameters=net.parameters()),
        loss=paddle.nn.CrossEntropyLoss(), metrics=paddle.metric.Accuracy())
    cb = FitSteps(torch, paddle.callbacks.Callback)
    real = counting(fap, plain, plain)
    try:
        for k in fap.launches:
            fap.launches[k] = 0
        fit_model.fit(Rows(), batch_size=ft["b"], epochs=1, shuffle=False,
                      verbose=0, jit_compile=False, callbacks=[cb.make()])
        ft_launches = dict(fap.launches)
        for k in fap.launches:
            fap.launches[k] = 0
        ev_logs = fit_model.evaluate(Rows(), batch_size=ft["b"],
                                     num_iters=ft["eval_batches"], verbose=0)
        ev_launches = dict(fap.launches)
    finally:
        restore(fap, real)
    finetune = {"batch": ft["b"], "seq": ft["s"], "losses": cb.series(),
                "compiled": fit_model._fit_used_compiled,
                "k1_launches": ft_launches, "eval": {
                    "logs": {k: float(np.asarray(v).reshape(-1)[0])
                             for k, v in ev_logs.items()},
                    "k1_launches": ev_launches}}
    del fit_model, net, cb
    torch.cuda.empty_cache()

    # (5) BatchNorm: Model.fit falls back to the eager loop; running stats
    # on the card against the CPU's
    paddle.set_device("cpu")
    bn_net = paddle.nn.Sequential(paddle.nn.Linear(10, 8),
                                  paddle.nn.BatchNorm1D(8),
                                  paddle.nn.Linear(8, 2))
    bn_state = {k: v.detach().clone() for k, v in bn_net.state_dict().items()}
    try:
        cpu_stats, cpu_compiled, _ = ernie_bn_fit(torch, paddle, "cpu",
                                                  bn_state)
        gpu_stats, gpu_compiled, reason = ernie_bn_fit(torch, paddle, "gpu",
                                                       bn_state)
    finally:
        pdevice._current = None
    bn_gap = max(float(np.abs(gpu_stats[k] - cpu_stats[k]).max())
                 for k in cpu_stats)
    bn = {"stats": sorted(gpu_stats), "max_abs_gap_to_cpu": bn_gap,
          "tol": ERNIE_BN["tol"], "eager": [not cpu_compiled,
                                            not gpu_compiled],
          "jit_compile_true": reason,
          "steps": ERNIE_BN["rows"] // ERNIE_BN["b"]}

    out = {"phase": "ernie", "nvidia_smi": smi,
           "model": "ernie-3.0-base-zh bf16", "batch": b, "seq": s,
           "masked_positions": {"k": len(pos), "masked": n_masked},
           "num_params": int(sum(v.size for v in arrays.values())),
           "kernel": {k: kernel[k] for k in ("shape", "causal", "readings",
                                             "control", "fault", "timing")},
           "kernel_seconds": t_kernel,
           "fwd_over_sdpa": kernel["timing"]["fwd"]["ms"]
           / kernel["timing"]["fwd"]["library_ms"],
           "bwd_pair_over_sdpa": (kernel["timing"]["dkdv"]["ms"]
                                  + kernel["timing"]["dq"]["ms"])
           / kernel["timing"]["dkdv"]["library_ms"],
           "flash": flash, "plain": ref, "step0_rel_diff": rel0,
           "rtol": ERNIE_REL_TOL, "series_max_abs_diff": max(diffs),
           "series_max_rel_diff": max(d / abs(c) for d, c in
                                      zip(diffs, ref["losses"])),
           "ms_per_step": flash["ms"], "tokens_per_s": tokens_s,
           "plain_ms_per_step": ref["ms"],
           "k1_launches": launches, "plain_k1_calls": plain,
           "profile_step": prof_sum,
           "k1_device_ms_in_profiled_step": k1_device_ms,
           "k1_share_of_busy": (k1_device_ms / 1e3 / prof_sum["device_busy_s"]
                                if prof_sum["device_busy_s"] else None),
           "heads": heads, "finetune": finetune, "batch_norm": bn,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    need = ERNIE_STEPS * L
    if any(n != need for n in launches.values()) or any(plain.values()):
        fails.append(f"K1 launches {launches} != {need} each, or plain "
                     f"calls {plain}")
    series = flash["losses"] + ref["losses"] + finetune["losses"]
    if not all(np.isfinite(series)):
        fails.append("non-finite loss")
    if not rel0 <= ERNIE_REL_TOL:
        fails.append(f"step 0: flash {flash['losses'][0]} vs plain "
                     f"{ref['losses'][0]} ({rel0} > {ERNIE_REL_TOL})")
    if not flash["losses"][-1] < flash["losses"][0]:
        fails.append(f"loss did not fall on a repeated batch: "
                     f"{flash['losses']}")
    if any(heads_launches.values()) or not heads_finite or not (
            heads_bitwise or heads_err <= ERNIE_HEADS_TOL):
        fails.append(f"heads: {heads}")
    ft_need = ft["steps"] * L
    if finetune["compiled"] or any(
            n != ft_need for n in ft_launches.values()):
        fails.append(f"fine-tune: compiled {finetune['compiled']}, K1 "
                     f"launches {ft_launches} != {ft_need}")
    if ev_launches["dkdv"] or ev_launches["dq"] or \
            ev_launches["fwd"] != ft["eval_batches"] * L or \
            "acc" not in finetune["eval"]["logs"]:
        fails.append(f"evaluate: {finetune['eval']}")
    if not all(bn["eager"]) or reason is None or "buffers" not in reason \
            or not bn_gap <= ERNIE_BN["tol"]:
        fails.append(f"batch norm fit: {bn}")
    if fails:
        raise AssertionError("ernie: " + "; ".join(fails))
    rows = {k: {key: kernel["timing"][k][key] for key in (
        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
        "library_ms")} for k in ("fwd", "dkdv", "dq")}
    return rows, launches


def fit_ab(torch, rounds):
    """``--fit-ab N``: where the eager fit's host time goes.  N rounds, in
    one process, of GPT-2-small bf16 (the fit phase's weights and
    batches) through the Paddle idiom, the eager fit from the buffered
    ring and from a list of batches already on the card, and the K-step
    trainer at K = 1 and K = 4; the order alternates each round.  ms/step
    from CUDA events as in the fit phase.  Then each loader alone: the
    wait for each of the 8 batches, synchronised."""
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import _build
    _build.build_all(["flash_attention_packed_w64"])
    import paddle_hackathon_tpu_torch as paddle
    from paddle_hackathon_tpu_torch.core import device as pdevice
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
    from paddle_hackathon_tpu_torch.nn import functional as F
    pdevice._current = None
    cfg = gpt_config("gpt2-small-en", hidden_dropout_prob=0.0,
                     attention_dropout_prob=0.0)
    arrays = random_weights(GPTForCausalLM(cfg, device="cpu"), seed=0)
    b = DYGRAPH_SHAPE["b"]
    rows = fit_rows(cfg.vocab_size, FIT_K_STEPS)

    class Rows(paddle.io.Dataset):
        def __len__(self):
            return len(rows[0])

        def __getitem__(self, i):
            return rows[0][i], rows[1][i]

    def loader(**kw):
        return paddle.io.DataLoader(Rows(), batch_size=b, shuffle=False,
                                    **kw)

    def optimizer(model):
        return paddle.optimizer.Adam(
            learning_rate=1e-4, beta2=0.95, parameters=model.parameters(),
            grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))

    def idiom():
        model = bf16_model(torch, cfg, arrays)
        opt = optimizer(model)
        evs = []
        for i in range(FIT_STEPS):
            loss = F.cross_entropy(
                model(paddle.to_tensor(rows[0][i * b:(i + 1) * b])),
                paddle.to_tensor(rows[1][i * b:(i + 1) * b]))
            loss.backward()
            opt.step()
            opt.clear_grad()
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            evs.append(ev)
            float(loss)
        torch.cuda.synchronize()
        return evs[FIT_TIMED[0]].elapsed_time(evs[FIT_TIMED[1]]) / \
            (FIT_TIMED[1] - FIT_TIMED[0])

    def fit(data, steps, timed, **kw):
        model = paddle.Model(bf16_model(torch, cfg, arrays),
                             inputs=["input_ids"], labels=["labels"])
        model.prepare(optimizer=optimizer(model.network),
                      loss=paddle.nn.CrossEntropyLoss())
        cb = FitSteps(torch, paddle.callbacks.Callback)
        model.fit(data, epochs=1, num_iters=steps, verbose=0,
                  callbacks=[cb.make()], **kw)
        return cb.ms_per_step(*timed)

    placed = [(paddle.to_tensor(rows[0][i * b:(i + 1) * b]),
               paddle.to_tensor(rows[1][i * b:(i + 1) * b]))
              for i in range(FIT_K_STEPS)]
    runs = [("idiom", idiom),
            ("eager_ring", lambda: fit(loader(num_workers=2), FIT_STEPS,
                                       FIT_TIMED, jit_compile=False)),
            ("eager_list", lambda: fit(placed, FIT_STEPS, FIT_TIMED,
                                       jit_compile=False)),
            ("k1_ring", lambda: fit(loader(num_workers=2), FIT_K_STEPS,
                                    FIT_TIMED, jit_compile=True,
                                    steps_per_execution=1)),
            ("k4_ring", lambda: fit(loader(num_workers=2), FIT_K_STEPS,
                                    (3, 7), jit_compile=True,
                                    steps_per_execution=4))]
    out = {"phase": "fit_ab", "nvidia_smi": nvidia_smi(), "rounds": []}
    for r in range(rounds):
        order = runs if r % 2 == 0 else runs[::-1]
        out["rounds"].append({name: fn() for name, fn in order})
        torch.cuda.empty_cache()
    for name, _ in runs:
        v = np.array([rd[name] for rd in out["rounds"]])
        out[name] = {"median": float(np.median(v)),
                     "q1": float(np.percentile(v, 25)),
                     "q3": float(np.percentile(v, 75))}
    for name, kw in (("alone_ring", dict(num_workers=2)),
                     ("alone_threads", dict(num_workers=2,
                                            use_buffer_reader=False)),
                     ("alone_single", dict(num_workers=0))):
        waits = []
        it = iter(loader(**kw))
        for _ in range(FIT_K_STEPS):
            t0 = time.perf_counter()
            next(it)
            torch.cuda.synchronize()
            waits.append((time.perf_counter() - t0) * 1e3)
        out[name + "_ms"] = waits
    emit(out)


# csrc/flash_tc.cuh's kernels: K1's instances (PACKED, Lb1E) and K2's
# bf16/f16 instances up to 256 (Lb0E)
TC_KERNEL = re.compile(r"flash_tc_(fwd|dkdv|dq)I(13__nv_bfloat16|6__half)"
                       r"Li(\d+)ELb([01])E")
TC_SMEM_INDEX = {"fwd": 0, "dkdv": 1, "dq": 2}


def tc_kernel_name(mangled, packed):
    """``flash_tc_dkdv<bf16,64>`` from a mangled flash_tc.cuh kernel name
    whose layout flag is ``packed`` (K1) or not (K2), or None for any other
    function."""
    m = TC_KERNEL.search(mangled)
    if not m or (m.group(4) == "1") != packed:
        return None
    dtype = "bf16" if "bfloat16" in m.group(2) else "f16"
    return f"flash_tc_{m.group(1)}<{dtype},{m.group(3)}>"


def hgmma_counts(_build, libs, lib_names, name):
    """Each kernel's count of HGMMA (wgmma) instructions in the SASS of
    ``lib_names``, for the kernels ``name`` (a mangled name -> short name,
    or None) picks; None where cuobjdump is not found."""
    import shutil
    from pathlib import Path
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    if not Path(cuobjdump).exists():
        return None
    hgmma = {}
    for lib_name in lib_names:
        sass = subprocess.run([cuobjdump, "-sass", str(libs[lib_name])],
                              capture_output=True, text=True,
                              timeout=300, check=True).stdout
        cur = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                cur = name(ln)
                if cur:
                    hgmma[cur] = 0
            elif cur and "HGMMA" in ln:
                hgmma[cur] += 1
    return hgmma


def tc_build(_build, libs, packed):
    """flash_tc.cuh's 18 instances of one family (forward, dK/dV, dQ;
    bf16/f16; 64/128/256 wide): K1's (``packed``, in the
    ``flash_attention_packed_w*`` libraries) or K2's (in the
    ``flash_attention_w*_h`` libraries).  Registers, spills, ptxas
    performance notes, and where cuobjdump is found each one's count of
    HGMMA (wgmma) instructions, which must be above 0 for all 18; K1's
    dynamic shared memory as its library exports it.  Only a library built
    in this run has ptxas's report."""
    import ctypes
    names = [f"flash_attention_packed_w{dp}" if packed
             else f"flash_attention_w{dp}_h" for dp in _build.FLASH_WIDTHS]

    def name(ln):
        return tc_kernel_name(ln, packed)
    smem = {}
    if packed:
        for lib_name in names:
            lib = ctypes.CDLL(str(libs[lib_name]))
            lib.flash_packed_smem.argtypes = [ctypes.c_int]
            dp = lib_name.rsplit("_w", 1)[1]
            for k, i in TC_SMEM_INDEX.items():
                smem[f"{k}<{dp}>"] = lib.flash_packed_smem(i)
    return dict(wide_tc_build(_build, libs, names, name, 18,
                              f"flash_tc kernels ({'K1' if packed else 'K2'})"),
                dynamic_smem_bytes=smem)


K2_TC_KERNEL = re.compile(r"(bhd_(?:fwd|dkdv|dq)_tc)ILi(\d+)E")
K3_SPLIT_KERNEL = re.compile(
    r"(paged_decode_split(?:_wide(?:_g)?)?)I(f|13__nv_bfloat16|6__half)"
    r"Li(\d+)E(?:Lb([01])E)?")
K3_TF32_KERNEL = re.compile(r"paged_attention_tf32ILi(\d+)ELi(\d+)ELb([01])E")


def ptxas_notes(_build, lib_names, name):
    """Registers, spills and ptxas's performance notes per kernel that
    ``name`` (a mangled name -> short name, or None) picks out of the
    libraries' build logs (only a library built in this run has them).  A
    note may come before its function's "Compiling entry function" line,
    so notes are matched by the name they carry."""
    out, notes = {}, {}
    for lib_name in lib_names:
        cur = None
        for ln in _build.build_logs.get(lib_name, "").splitlines():
            if "Compiling entry function" in ln:
                cur = name(ln)
                if cur:
                    out[cur] = {"ptxas": [], "perf_notes": []}
            elif "Potential Performance Loss" in ln:
                if name(ln):
                    notes.setdefault(name(ln), []).append(
                        ln.split("Loss:")[-1].split(" in the")[0]
                        .split(" for the")[0].strip())
            elif cur and ("Used" in ln or "spill" in ln):
                out[cur]["ptxas"].append(ln.split("info    :")[-1].strip())
    for n, found in notes.items():
        out.setdefault(n, {"ptxas": [], "perf_notes": []})[
            "perf_notes"] += found
    return out


def k2_tc_build(_build, libs):
    """The 3xTF32 forward, dK/dV and dQ kernels (64/128/256 wide: 9), as
    ``wide_tc_build``."""
    def name(ln):
        m = K2_TC_KERNEL.search(ln)
        return f"{m.group(1)}<{m.group(2)}>" if m else None

    return wide_tc_build(_build, libs, [f"flash_attention_w{dp}_f32"
                                        for dp in _build.FLASH_WIDTHS],
                         name, 9, "3xTF32 kernels")


def k3_tf32_build(_build, libs):
    """K3's f32 prefill kernel on 3xTF32 wgmma, its TMA and gathered
    instances (padded widths 64, 128, 256 and 0, past 256 in 160-column
    chunks; one or two consumer warpgroups: 12 instances)."""
    def name(ln):
        m = K3_TF32_KERNEL.search(ln)
        return (f"paged_attention_tf32<{m.group(1)},{m.group(2)},"
                f"{'gathered' if m.group(3) == '1' else 'tma'}>" if m
                else None)
    return wide_tc_build(_build, libs, ["paged_attention"], name, 12,
                         "K3 f32 prefill kernels")


def k3_split_build(_build):
    """The split decode kernel's (f32, bf16, f16; widths up to 1 and 15;
    up to D = 256 and past it, ``paged_decode_split_wide``; TMA and
    gathered instances) ptxas notes."""
    def name(ln):
        m = K3_SPLIT_KERNEL.search(ln)
        if not m:
            return None
        gathered = m.group(4) == "1" or m.group(1).endswith("_g")
        return (f"{m.group(1).removesuffix('_g')}<"
                f"{m.group(2).lstrip('0123456789')},{m.group(3)},"
                f"{'gathered' if gathered else 'tma'}>")
    return ptxas_notes(_build, ["paged_attention"], name)


WIDE_FWD_KERNEL = re.compile(r"4wide(6fwd_tc|10fwd_tc_f32)I"
                             r"(?:(13__nv_bfloat16|6__half)Lb([01])E|Li\d+E)")


def wide_fwd_name(ln):
    """``fwd_tc<bf16,K1>`` / ``fwd_tc<f16,K2>`` / ``fwd_tc_f32`` from a
    line naming a tensor-core forward past 256, or None."""
    m = WIDE_FWD_KERNEL.search(ln)
    if not m:
        return None
    if m.group(1) == "10fwd_tc_f32":
        return "fwd_tc_f32"
    dtype = "bf16" if "bfloat16" in m.group(2) else "f16"
    return f"fwd_tc<{dtype},{'K1' if m.group(3) == '1' else 'K2'}>"


def wide_tc_build(_build, libs, names, name, count, what):
    """``count`` tensor-core kernels that ``name`` picks out of the
    libraries ``names``: registers, spills, ptxas performance notes and,
    where cuobjdump is found, their HGMMA (wgmma) counts, above 0 for
    each."""
    hgmma = hgmma_counts(_build, libs, names, name)
    if hgmma is not None and (len(hgmma) != count
                              or not all(hgmma.values())):
        raise AssertionError(f"{what} without HGMMA (or missing from the "
                             f"SASS): {hgmma}")
    return {"kernels": ptxas_notes(_build, names, name), "hgmma": hgmma}


def wide_fwd_build(_build, libs):
    """The tensor-core forwards past 256 (K1 bf16/f16, K2 bf16/f16, K2
    f32: 5)."""
    return wide_tc_build(_build, libs, [
        "flash_attention_packed_wide", "flash_attention_wide_h",
        "flash_attention_wide_f32"], wide_fwd_name, 5,
        "wide tensor-core forwards")


WIDE_BWD_KERNEL = re.compile(r"4wide(7dkdv_tc|5dq_tc)I"
                             r"(13__nv_bfloat16|6__half)Lb([01])E")


def wide_bwd_name(ln):
    """``dkdv_tc<bf16,K1>`` / ``dq_tc<f16,K2>`` from a line naming a
    tensor-core backward kernel past 256, or None."""
    m = WIDE_BWD_KERNEL.search(ln)
    if not m:
        return None
    dtype = "bf16" if "bfloat16" in m.group(2) else "f16"
    kernel = m.group(1).lstrip("0123456789")
    return f"{kernel}<{dtype},{'K1' if m.group(3) == '1' else 'K2'}>"


def wide_bwd_build(_build, libs):
    """The tensor-core dK/dV and dQ kernels past 256 (K1 and K2,
    bf16/f16: 8)."""
    return wide_tc_build(_build, libs, [
        "flash_attention_packed_wide", "flash_attention_wide_h"],
        wide_bwd_name, 8, "wide tensor-core backward kernels")


def wide_f32_bwd_build(_build, libs):
    """K2's f32 dK/dV and dQ past 256, the 3xTF32 pair at a run-time width
    (``bhd_dkdv_tc<0>``, ``bhd_dq_tc<0>``: 2)."""
    def name(ln):
        m = K2_TC_KERNEL.search(ln)
        return f"{m.group(1)}<0>" if m and m.group(2) == "0" else None
    return wide_tc_build(_build, libs, ["flash_attention_wide_f32"], name, 2,
                         "f32 backward kernels past 256")


K3_TC_KERNEL = re.compile(r"paged_attention_tcI(13__nv_bfloat16|6__half)"
                          r"Li(\d+)ELi(\d+)ELb([01])E")


def k3_tc_name(ln):
    """``paged_attention_tc<bf16,64,2,tma>`` (type, output chunk,
    consumers, producer) from a line naming K3's bf16/f16 prefill kernel
    on wgmma, or None."""
    m = K3_TC_KERNEL.search(ln)
    if not m:
        return None
    dtype = "bf16" if "bfloat16" in m.group(1) else "f16"
    producer = "gathered" if m.group(4) == "1" else "tma"
    return (f"paged_attention_tc<{dtype},{m.group(2)},{m.group(3)},"
            f"{producer}>")


def k3_tc_build(_build, libs):
    """K3's bf16/f16 prefill kernel on wgmma: output chunks of 64 and 128
    columns with one or two consumer warpgroups, 256 with one (up to D =
    256 one chunk, past it chunks of 256), bf16 and f16, the TMA and the
    gathered producer: 20."""
    return wide_tc_build(_build, libs, ["paged_attention"], k3_tc_name, 20,
                         "K3 bf16/f16 prefill kernels")


K4_KERNEL = re.compile(r"(quant_matmul_(?:tc|f32)_kernel)I"
                       r"(13__nv_bfloat16|6__half)?Lb([01])E"
                       r"(?:Li(\d+)E)?(?:Lb([01])E)?")


def k4_kernel_name(ln):
    """``quant_matmul_tc_kernel<bf16,fp8,split>`` or
    ``quant_matmul_f32_kernel<int8,R8,walk>`` (R rows a thread) from a
    line naming a K4 kernel."""
    m = K4_KERNEL.search(ln)
    if not m:
        return None
    w = "fp8" if m.group(3) == "1" else "int8"
    sched = "split" if m.group(5) == "1" else "walk"
    if m.group(2) is None:
        return f"{m.group(1)}<{w},R{m.group(4)},{sched}>"
    x = "bf16" if "bfloat16" in m.group(2) else "f16"
    return f"{m.group(1)}<{x},{w},{sched}>"


def k4_build(_build, libs):
    """K4's kernels' registers, spills and ptxas performance notes and,
    where cuobjdump is found, their HGMMA (wgmma) counts: above 0 for each
    of the 8 tensor-core instances (bf16/f16, int8/fp8, walk/split), 0 for
    the 8 CUDA-core (f32) ones (int8/fp8, 2 or 8 rows a thread,
    walk/split)."""
    hgmma = hgmma_counts(_build, libs, ["quant_matmul"], k4_kernel_name)
    if hgmma is not None:
        tc = {k: v for k, v in hgmma.items() if "_tc_" in k}
        if len(tc) != 8 or not all(tc.values()) or len(hgmma) != 16:
            raise AssertionError(f"K4 tensor-core kernels without HGMMA (or "
                                 f"missing from the SASS): {hgmma}")
    return {"kernels": ptxas_notes(_build, ["quant_matmul"], k4_kernel_name),
            "hgmma": hgmma}


def main():
    if "--ab-medians" in sys.argv:
        ab_medians(sys.argv[sys.argv.index("--ab-medians") + 1])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    for flag, mode in (("--serving-ab", serving_ab), ("--layer-ab", layer_ab),
                       ("--bwd-ab", bwd_ab),
                       ("--tc16-ab", tc16_ab), ("--k3-ab", k3_ab),
                       ("--k4-ab", k4_ab), ("--fit-ab", fit_ab)):
        if flag in sys.argv:
            args = sys.argv[1:]
            if "--root" in args:
                sys.path.insert(0, args[args.index("--root") + 1])
            emit({"phase": "device", "nvidia_smi": nvidia_smi(),
                  "root": sys.path[0]})
            arg = args[args.index(flag) + 1]
            mode(torch, int(arg))
            return 0
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import _build
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        flash_attention as fa
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        flash_attention_packed as fap
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        paged_attention as pa
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        quant_matmul as qm
    from paddle_hackathon_tpu_torch.nn.quant import weight_only as wo

    if "--spec" in sys.argv:
        # the spec phase alone: K3's and K4's libraries, then its runs
        emit({"phase": "device", "nvidia_smi": nvidia_smi(),
              "name": torch.cuda.get_device_name(0)})
        t0 = time.perf_counter()
        _build.build_all(["paged_attention", "quant_matmul"])
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        phase_spec(torch, pa, qm)
        return 0
    if "--stages" in sys.argv:
        # the stages phase alone: K3's and K4's libraries, then its runs
        emit({"phase": "device", "nvidia_smi": nvidia_smi(),
              "name": torch.cuda.get_device_name(0)})
        t0 = time.perf_counter()
        _build.build_all(["paged_attention", "quant_matmul"])
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        phase_stages(torch, pa, qm)
        return 0
    if "--dygraph" in sys.argv:
        # the dygraph phase alone: K1's library (D = 64)
        emit({"phase": "device", "nvidia_smi": nvidia_smi(),
              "name": torch.cuda.get_device_name(0)})
        t0 = time.perf_counter()
        _build.build_all(["flash_attention_packed_w64"])
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        phase_dygraph(torch, fap)
        return 0
    if "--fit" in sys.argv:
        # the fit phase alone: K1's library (D = 64)
        emit({"phase": "device", "nvidia_smi": nvidia_smi(),
              "name": torch.cuda.get_device_name(0)})
        t0 = time.perf_counter()
        _build.build_all(["flash_attention_packed_w64"])
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        phase_fit(torch, fap)
        return 0
    if "--ernie" in sys.argv:
        # the ernie phase alone: K1's library (D = 64)
        emit({"phase": "device", "nvidia_smi": nvidia_smi(),
              "name": torch.cuda.get_device_name(0)})
        t0 = time.perf_counter()
        _build.build_all(["flash_attention_packed_w64"])
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        phase_ernie(torch, fap)
        return 0
    if "--deploy" in sys.argv:
        # the deploy phase alone: K1's (D = 64), K3's and K4's libraries
        emit({"phase": "device", "nvidia_smi": nvidia_smi(),
              "name": torch.cuda.get_device_name(0)})
        t0 = time.perf_counter()
        _build.build_all(["paged_attention", "quant_matmul",
                          "flash_attention_packed_w64"])
        emit({"phase": "build", "seconds": time.perf_counter() - t0})
        phase_deploy(torch, fap, pa, qm)
        return 0
    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    register_unswizzled(_build)
    libs = _build.build_all()
    # ptxas's register / spill lines, per library built in this run
    ptxas = {lib: [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                   if "Used" in ln or "spill" in ln]
             for lib, log in _build.build_logs.items()}
    k3_build = {"k3_split_decode": k3_split_build(_build),
                "k3_tf32": k3_tf32_build(_build, libs),
                "k3_tc": k3_tc_build(_build, libs)}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library_seconds": _build.build_seconds,
          "libraries": sorted(p.name for p in libs.values()),
          "ptxas": ptxas, "k1": tc_build(_build, libs, True),
          "k2_tc16": tc_build(_build, libs, False),
          "k2_3xtf32": k2_tc_build(_build, libs),
          "k4": k4_build(_build, libs),
          "wide_fwd_tc": wide_fwd_build(_build, libs),
          "wide_bwd_tc": wide_bwd_build(_build, libs),
          "wide_bwd_tc_f32": wide_f32_bwd_build(_build, libs),
          **k3_build})

    flash = phase_flash(torch, fap, fa)
    flash_launches = phase_train(torch, fap)
    phase_train_optim(torch, fap)
    dygraph = phase_dygraph(torch, fap)
    fit = phase_fit(torch, fap)
    ernie, ernie_launches = phase_ernie(torch, fap)
    bhd, tc16 = phase_flash_bhd(torch, fa, fap,
                                phase_flash_bhd_checks(torch, fa))
    bhd_launches = phase_train_f32(torch, fa, fap)
    phase_wide(torch, fa, fap)
    wide_launches = phase_wide(torch, fa, fap, b=2, gpt=WIDE512_GPT,
                               name="wide512")
    wide512 = wide512_times(torch, fa, fap, pa)
    emit({"phase": "wide512_times", **wide512})
    phase_dispatch_repairs(torch, fap, pa, qm, wo)
    k3_decode, k3_tc, k3_f32, k3_retired, k3_verify = phase_kernel(torch, pa)
    eng, prompts, launches, f32_launches_k3 = phase_serving(torch, pa)
    phase_profile(torch, eng, prompts)
    del eng
    wide_f32_launches = phase_paged_wide(torch, pa)
    k3_wide_launches = phase_paged_wide512(torch, pa)
    p12_launches = phase_paged_p12(torch, pa)
    max_abs, max_abs_f32 = phase_quant_checks(torch, qm, wo)
    decode, decode_f32, prefill_f32, k4_m72 = phase_quant(torch, qm, wo)
    k4_launches, arrays, prompts, int8 = phase_serving_int8(torch, qm)
    f32_launches = phase_quant_f32_cross_check(torch, qm, arrays, prompts)
    spec_launches = phase_spec(torch, pa, qm, int8)
    phase_stages(torch, pa, qm, int8)
    del int8
    deploy = phase_deploy(torch, fap, pa, qm)

    src = "paddle_hackathon_tpu_torch/csrc/"
    ref = "paddle_hackathon_tpu/incubate/nn/kernels/"
    kernels = [
        {"name": f"flash_packed_{k}", "route": "cuda",
         "source": src + "flash_attention_packed.cu",
         "replaces": ref + f"flash_attention_packed.py:{line}",
         "launches": flash_launches[k], **flash[k]}
        for k, line in (("fwd", 247), ("dkdv", 478), ("dq", 511))]
    kernels += [
        {"name": f"flash_bhd_{k}", "route": "cuda",
         "source": src + "flash_attention.cu",
         "replaces": ref + f"flash_attention.py:{line}",
         "launches": bhd_launches[k], **bhd[k],
         "timed_as": "f32, BH=16*12, s=1024, D=64, causal (the train_f32 "
                     "step's attention); library: PyTorch's efficient-"
                     "attention SDPA; bound: fwd, dkdv and dq as 3xTF32 "
                     "products on the tensor cores"}
        for k, line in (("fwd", 285), ("dkdv", 525), ("dq", 556))]
    # K2's bf16/f16 kernels up to 256 (flash_tc.cuh): launches from three
    # passes through the public flash_attention at D = 64, times at each
    # of K2_TC16_SHAPES
    for k, line in (("fwd", 285), ("dkdv", 525), ("dq", 556)):
        for key, row in tc16.items():
            kernels.append({
                "name": f"flash_bhd_{k}_bf16" + ("" if key == "d64"
                                                 else f"_{key}"),
                "route": "cuda", "source": src + "flash_tc.cuh",
                "replaces": ref + f"flash_attention.py:{line}",
                "launches": tc16["d64"]["api_launches"][
                    "fwd_tc16" if k == "fwd" else f"{k}_tc16"],
                **row[k],
                "timed_as": f"bf16, b={row['shape']['b']}, "
                            f"H={row['shape']['H']}, s=1024, "
                            f"D={row['shape']['D']}, causal; launches: "
                            f"three passes through flash_attention at "
                            f"D=64; plain: the plain "
                            f"{'forward' if k == 'fwd' else 'pair'}; "
                            f"library: SDPA bf16 "
                            f"{'forward' if k == 'fwd' else 'backward'}, "
                            f"default backend; bound: bf16 tensor cores"})
    # the tensor-core forward past 256: launches from the wide512 GPT's
    # flash series (bf16 through K1, f32 through K2), times at its attention
    for kname, tag, fam, file, line in (
            ("flash_packed_fwd_wide", "k1_bf16", "bf16",
             "flash_attention_packed.py", 247),
            ("flash_bhd_fwd_wide_f32", "k2_f32", "f32", "flash_attention.py",
             285)):
        row = wide512[tag]["fwd"]
        kernels.append({
            "name": kname, "route": "cuda", "source": src + "flash_wide.cuh"
            if fam == "bf16" else src + "flash_attention.cu",
            "replaces": ref + f"{file}:{line}",
            "launches": wide_launches[fam]["wide_fwd_tc"],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            "timed_as": f"{fam}, b=2, H=2, s=1024, D=512, causal (the "
                        f"wide512 GPT's attention); library: SDPA, default "
                        f"backend; bound: the tensor cores "
                        f"({'bf16' if fam == 'bf16' else '3xTF32'})"})
    # the tensor-core backward past 256: K1's launches from the wide512
    # GPT's bf16 flash series, K2's from three passes through the public
    # flash_attention at its attention; times at that attention
    for kname, tag, k, launched, file, line in (
            ("flash_packed_dkdv_wide", "k1_bf16", "dkdv",
             wide_launches["bf16"]["dkdv_wide_tc"],
             "flash_attention_packed.py", 478),
            ("flash_packed_dq_wide", "k1_bf16", "dq",
             wide_launches["bf16"]["dq_wide_tc"],
             "flash_attention_packed.py", 511),
            ("flash_bhd_dkdv_wide_bf16", "k2_bf16", "dkdv",
             wide512["k2_bf16"]["api_launches"]["dkdv_wide_tc"],
             "flash_attention.py", 525),
            ("flash_bhd_dq_wide_bf16", "k2_bf16", "dq",
             wide512["k2_bf16"]["api_launches"]["dq_wide_tc"],
             "flash_attention.py", 556)):
        row = wide512[tag][k]
        kernels.append({
            "name": kname, "route": "cuda", "source": src + "flash_wide.cuh",
            "replaces": ref + f"{file}:{line}", "launches": launched,
            "max_abs_err": row["max_abs_err"],
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
            "timed_as": "bf16, b=2, H=2, s=1024, D=512, causal (the wide512 "
                        "GPT's attention); plain: the plain dK/dV + dQ "
                        "pair; library: SDPA's backward (dq, dk, dv), "
                        "default backend; bound: bf16 tensor cores"})
    # K2's f32 backward past 256: launches from the wide512 GPT's f32 flash
    # series, times at its attention
    for kname, k, line in (("flash_bhd_dkdv_wide_f32", "dkdv", 525),
                           ("flash_bhd_dq_wide_f32", "dq", 556)):
        row = wide512["k2_f32"][k]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src + "flash_attention.cu",
            "replaces": ref + f"flash_attention.py:{line}",
            "launches": wide_launches["f32"][f"{k}_wide_tc_f32"],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            "timed_as": "f32, b=2, H=2, s=1024, D=512, causal (the wide512 "
                        "GPT's attention); plain: the plain dK/dV + dQ "
                        "pair; library: SDPA's f32 backward (dq, dk, dv), "
                        "default backend; bound: 3xTF32 products on the "
                        "tensor cores"})
    row = wide512["k3_bf16"]["w32"]
    kernels.append({
        "name": "paged_attention_tc_d512", "route": "cuda",
        "source": src + "paged_attention.cu",
        "replaces": ref + "paged_attention.py:175",
        "launches": k3_wide_launches["tiles_wide_tc"],
        **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
        "timed_as": "a 32-row prefill chunk at D=512, bf16 (16 slots, 12 "
                    "heads, pages of 16, 8 a slot; paged_attention_tc in "
                    "256-column chunks, route tiles_wide_tc); launches: "
                    "the paged engine at the wide512 GPT's heads; library: "
                    "SDPA with the offset-causal mask on gathered K/V"})
    row = wide512["k3_bf16"]["w1"]
    kernels.append({
        "name": "paged_decode_split_d512", "route": "cuda",
        "source": src + "paged_attention.cu",
        "replaces": ref + "paged_attention.py:175",
        "launches": k3_wide_launches["split"],
        **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                     "bound_ms", "bound_by", "library_ms")},
        "timed_as": "width-1 decode at D=512, bf16 (16 slots, 12 heads, "
                    "pages of 16, 8 a slot; the split kernel's row in "
                    "column slices, paged_decode_split_wide); launches: "
                    "the paged engine's decode steps at the wide512 GPT's "
                    "heads; library: SDPA on K/V gathered contiguous"})
    for kname, key, launched, what in (
            ("paged_attention_tf32", "w32", f32_launches_k3["tiles_tf32"],
             "a 32-row prefill chunk at the serving run's geometry in f32 "
             "(16 slots, 12 heads of 64, pages of 16); launches: the f32 "
             "paged engine of the serving cross-check"),
            ("paged_attention_tf32_w128", "w128",
             wide_f32_launches["tiles_tf32"],
             "a 128-row prefill chunk over pages of 128, f32 (16 slots, 12 "
             "heads of 64, 4 pages a slot); launches: the paged_wide "
             "engine (chunk 128, pages of 128)")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src + "paged_attention.cu",
            "replaces": ref + "paged_attention.py:175",
            "launches": launched, **k3_f32[key],
            "timed_as": what + "; library: SDPA f32 (TF32 off) with the "
                        "offset-causal mask on gathered K/V; bound: bytes "
                        "or 3xTF32 products on the tensor cores"})
    kernels.append({"name": "paged_decode_split", "route": "cuda",
                    "source": src + "paged_attention.cu",
                    "replaces": ref + "paged_attention.py:175",
                    "launches": launches["paged_decode"], **k3_decode,
                    "timed_as": "width-1 decode at the serving run's "
                                "geometry (16 slots, 12 heads of 64, pages "
                                "of 16, lengths 64..191), bf16; library: "
                                "SDPA on K/V gathered contiguous"})
    # the spec phase's paged verify tick: width 9 on the split kernel;
    # launches: the split kernel's in one spec run of the paged engine
    # (12 a verify tick, 12 a decode step)
    for tag in ("bf16", "f32"):
        row = k3_verify[tag]
        kernels.append({
            "name": f"paged_decode_split_verify_w9_{tag}", "route": "cuda",
            "source": src + "paged_attention.cu",
            "replaces": ref + "paged_attention.py:175",
            "launches": spec_launches["k3"].get("split", 0)
            if tag == "bf16" else 0,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "timed_as": f"the verify tick's attention, width 9, {tag} (8 "
                        f"slots, 12 heads of 64, pages of 16, lengths "
                        f"64..191; route {row['kernel']}); launches: one "
                        f"spec run of the paged engine (bf16; the f32 "
                        f"row's path is not run); library: SDPA with the "
                        f"offset-causal mask on gathered K/V"})
    # the bf16/f16 prefill chunks up to 256 on paged TMA + wgmma: the
    # serving chunk (launched by the serving run), and off the main path
    # the chunk of 128 over pages of 128 and D = 128, 256
    for kname, key, launched, what in (
            ("paged_attention_tc", "w32", launches["tiles_tc"],
             "a 32-row prefill chunk at the serving run's geometry, bf16 "
             "(16 slots, 12 heads of 64, pages of 16); launches: the "
             "serving run's chunk ticks x layers"),
            ("paged_attention_tc_w128", "w128", 0,
             "a 128-row chunk over pages of 128, bf16, D=64 (16 slots, 12 "
             "heads, 4 pages a slot; two consumer warpgroups)"),
            ("paged_attention_tc_d128_w32", "d128_w32", 0,
             "a 32-row chunk at D=128, bf16 (16 slots, 12 heads, pages of "
             "16)"),
            ("paged_attention_tc_d128_w128", "d128_w128", 0,
             "a 128-row chunk at D=128 over pages of 128, bf16"),
            ("paged_attention_tc_d256_w32", "d256_w32", 0,
             "a 32-row chunk at D=256, bf16 (16 slots, 12 heads, pages of "
             "16)"),
            ("paged_attention_tc_d256_w128", "d256_w128", 0,
             "a 128-row chunk at D=256 over pages of 128, bf16")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src + "paged_attention.cu",
            "replaces": ref + "paged_attention.py:175",
            "launches": launched, **k3_tc[key],
            "timed_as": what + "; library: SDPA with the offset-causal "
                        "mask on gathered K/V; bound: bytes or bf16 "
                        "tensor-core products"})
    # the shapes the retired kernels ran, on the TMA or gathered instance
    # their route names (launches: the page-12 engine runs for pages of 12,
    # no engine run of this script at the others), each with its
    # instance's registers, spills, ptxas notes and HGMMA count
    tc_g = "paged_attention_tc<bf16,{},1,gathered>"
    tf32 = "paged_attention_tf32<{},1,{}>"
    for kname, key, block, inst, launched in (
            ("paged_attention_tc_g_p12", "bf16_p12_w32", "k3_tc",
             tc_g.format(64), p12_launches["bfloat16"]["tiles_tc_g"]),
            ("paged_attention_tc_g_d36", "bf16_d36_w32", "k3_tc",
             tc_g.format(64), 0),
            ("paged_attention_tc_g_d260", "bf16_d260_w32", "k3_tc",
             tc_g.format(256), 0),
            ("paged_attention_tf32_d320", "f32_d320_w32", "k3_tf32",
             tf32.format(0, "tma"), 0),
            ("paged_attention_tf32_g_p12", "f32_p12_w32", "k3_tf32",
             tf32.format(64, "gathered"),
             p12_launches["float32"]["tiles_tf32_g"]),
            ("paged_attention_tf32_g_d38", "f32_d38_w32", "k3_tf32",
             tf32.format(64, "gathered"), 0),
            ("paged_decode_split_g_d36", "bf16_d36_w1", "k3_split_decode",
             "paged_decode_split<__nv_bfloat16,1,gathered>", 0)):
        rep = k3_build[block]
        report = {"instance": inst,
                  "ptxas": rep.get("kernels", rep).get(inst),
                  "hgmma": (rep.get("hgmma") or {}).get(inst)}
        row = k3_retired[key]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src + "paged_attention.cu",
            "replaces": ref + "paged_attention.py:175",
            "launches": launched,
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            **report,
            "timed_as": f"{key} (16 slots, 12 heads; route "
                        f"{row['kernel']}); launches: "
                        + ("the page-12 engine's chunk ticks x layers"
                           if launched else "no engine run of this script")
                        + "; library: SDPA with the offset-causal mask on "
                          "gathered K/V"})
    kernels.append({"name": "quant_matmul", "route": "cuda",
                    "source": src + "quant_matmul.cu",
                    "replaces": ref + "quant_matmul.py:112",
                    "launches": k4_launches, "max_abs_err": max_abs,
                    "ms": decode["ms"], "plain_ms": decode["plain_ms"],
                    "bound_ms": decode["bound_ms"],
                    "bound_by": decode["bound_by"],
                    "library_ms": decode["library_ms"],
                    "timed_as": "one decode layer's 4 projections, M=8, "
                                "int8, bf16 activations (the tensor-core "
                                "kernel's split; library: the quant "
                                "phase's)"})
    kernels.append({"name": "quant_matmul_m72", "route": "cuda",
                    "source": src + "quant_matmul.cu",
                    "replaces": ref + "quant_matmul.py:112",
                    "launches": spec_launches["k4"], "max_abs_err": max_abs,
                    **{k: k4_m72[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")},
                    "timed_as": "one layer's 4 projections at M=72 (the "
                                "int8 verify tick: 8 slots x width 9), "
                                "int8, bf16 activations; launches: one spec "
                                "run of the int8 engine; max_abs_err: the "
                                "quant_checks phase's (M=72 among its "
                                "cases)"})
    kernels.append({"name": "quant_matmul_f32", "route": "cuda",
                    "source": src + "quant_matmul.cu",
                    "replaces": ref + "quant_matmul.py:112",
                    "launches": f32_launches, "max_abs_err": max_abs_f32,
                    "ms": decode_f32["ms"],
                    "plain_ms": decode_f32["plain_ms"],
                    "bound_ms": decode_f32["bound_ms"],
                    "bound_by": decode_f32["bound_by"],
                    "library_ms": decode_f32["library_ms"],
                    "timed_as": "one decode layer's 4 projections, M=8, "
                                "int8, f32 activations (the CUDA-core "
                                "kernel's split); launches: the f32 "
                                "cross-check's engines; max_abs_err: the "
                                "quant_checks phase's"})
    kernels.append({"name": "quant_matmul_f32_m256", "route": "cuda",
                    "source": src + "quant_matmul.cu",
                    "replaces": ref + "quant_matmul.py:112",
                    "launches": f32_launches, "max_abs_err": max_abs_f32,
                    **{k: prefill_f32[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")},
                    "timed_as": "one layer's 4 projections at M=256 "
                                "(a prefill chunk), int8, f32 activations "
                                "(the walk for qkv and fc_in, the split "
                                "for out and fc_out); launches: the same "
                                "kernel's in the f32 cross-check"})
    # the deployment surface's paths (phase deploy): K1 through the
    # predictor and the QAT fine-tune, K4 through the int8 predictor and
    # the QAT-converted engine, K3 through the fleet's replicas; each row's
    # times are the same kernel's rows above
    for kname, k, line, row, what in (
            ("flash_packed_fwd_deploy", "fwd", 247, flash["fwd"],
             "the bf16 and int8 predictors at b=4, s=1024 and the QAT "
             "fine-tune's forwards"),
            ("flash_packed_dkdv_qat", "dkdv", 478, flash["dkdv"],
             "the QAT fine-tune's backwards"),
            ("flash_packed_dq_qat", "dq", 511, flash["dq"],
             "the QAT fine-tune's backwards")):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src + "flash_attention_packed.cu",
            "replaces": ref + f"flash_attention_packed.py:{line}",
            "launches": deploy["k1"][k],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            "timed_as": f"launches: {what}; times: the flash_packed_{k} "
                        f"row's"})
    kernels.append({
        "name": "quant_matmul_deploy", "route": "cuda",
        "source": src + "quant_matmul.cu",
        "replaces": ref + "quant_matmul.py:112",
        "launches": deploy["k4"], "max_abs_err": max_abs,
        **{k: decode[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
        "timed_as": "launches: the int8 predictor (M = 4096) and the "
                    "QAT-converted dense engine (M = 8 decode, 256 "
                    "prefill); times: the quant_matmul row's"})
    for kname, key, row in (
            ("paged_attention_tc_fleet", "tiles_tc", k3_tc["w32"]),
            ("paged_decode_split_fleet", "split", k3_decode)):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": src + "paged_attention.cu",
            "replaces": ref + "paged_attention.py:175",
            "launches": deploy["k3"].get(key, 0),
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")},
            "timed_as": "launches: the fleet's two paged replicas over all "
                        "its runs (counted per replica); times: the "
                        + ("paged_attention_tc" if key == "tiles_tc"
                           else "paged_decode_split") + " row's"})
    # the dygraph surface's path (phase dygraph): K1 through GPT-2-small's
    # Paddle-idiom steps; times are the flash_packed rows'
    for k, line in (("fwd", 247), ("dkdv", 478), ("dq", 511)):
        row = flash[k]
        kernels.append({
            "name": f"flash_packed_{k}_dygraph", "route": "cuda",
            "source": src + "flash_attention_packed.cu",
            "replaces": ref + f"flash_attention_packed.py:{line}",
            "launches": dygraph[k],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            "timed_as": "launches: the dygraph phase's 7 Paddle-idiom "
                        "steps of GPT-2-small at b=8, s=1024; times: the "
                        f"flash_packed_{k} row's"})
    # Model.fit's path (phase fit): K1 through GPT-2-small's eager fit
    # (7 steps), the K-step trainer at K = 1 and at K = 4 (8 steps each)
    for k, line in (("fwd", 247), ("dkdv", 478), ("dq", 511)):
        row = flash[k]
        kernels.append({
            "name": f"flash_packed_{k}_fit", "route": "cuda",
            "source": src + "flash_attention_packed.cu",
            "replaces": ref + f"flash_attention_packed.py:{line}",
            "launches": fit[k],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            "timed_as": "launches: the fit phase's 30 Model.fit steps of "
                        "GPT-2-small at b=8, s=1024 (eager 7, K=1 7 and 8, "
                        f"K=4 8); times: the flash_packed_{k} row's"})
    # the encoder's path (phase ernie): K1 non-causal through
    # ERNIE-3.0-base's 10 MLM steps; times at its attention
    for k, line in (("fwd", 247), ("dkdv", 478), ("dq", 511)):
        kernels.append({
            "name": f"flash_packed_{k}_ernie", "route": "cuda",
            "source": src + "flash_attention_packed.cu",
            "replaces": ref + f"flash_attention_packed.py:{line}",
            "launches": ernie_launches[k], **ernie[k],
            "timed_as": "bf16, b=64, H=12, s=512, D=64, non-causal (the "
                        "ERNIE-3.0-base encoder's attention); launches: "
                        "the ernie phase's 10 MLM steps; plain: the plain "
                        + ("forward" if k == "fwd" else "backward")
                        + "; library: SDPA bf16, non-causal, default "
                          "backend; bound: bf16 tensor cores or bytes"})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
