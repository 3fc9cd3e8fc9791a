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
               spill lines; for each K1 kernel (forward, dK/dV and dQ,
               bf16/f16, 64/128/256 wide: 18) and each of K2's 3xTF32
               forward, dK/dV and dQ kernels (64/128/256: 9) its
               registers, spills, ptxas's performance notes (K1: its
               dynamic shared memory), and, where ``cuobjdump`` is found,
               its count of HGMMA (wgmma) instructions, which must be above
               0; and the split decode kernel's (K3) ptxas notes.
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
               column-chunked kernels at D=320 (H=2) and D=512 (H=1; H=2
               non-causal with dropout 0.1); b*H = 65538 (past a grid's y
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
               ``torch.profiler``), which the port never calls; and the
               backward pair beside K2's bf16 dK/dV + dQ at the same shape
               (``backward_pair``).  Then the same three kernels at D=256
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
5. train_profile -- one train step under ``torch.profiler``: device idle
               share, top device kernels and host ops.
6. flash_bhd_checks -- holds the three bhd flash-attention kernels K2
               (forward, dK/dV, dQ; ``csrc/flash_attention.cu``) against their
               plain versions on the same inputs: f32 against the plain
               version in f64, bf16/f16 against it in f32; forward O and LSE,
               and the gradient through ``FlashAttentionBHD``, each slice
               apart.  Cases: causal and non-causal, dropout 0.1 with a fixed
               seed, sq=256/skv=1024 and sq=1024/skv=256 causal, ragged
               s=1000, D = 32, 80, 128, 256 and 36 (rows not 16-byte aligned
               in bf16/f16) and, past 256, 264, 320 and 512, each in f32,
               bf16 and f16; f32 at D=33 (rows TMA cannot address) and at
               D=264 with dropout and sq != skv; the f32 training
               geometry (B*H = 16*12, s=1024, D=64); batch 1 through
               ``flash_attention_bshd`` on strided views of one fused
               projection (f32 at H=12, s=1024; bf16 at H=1); and the ring's
               unit: ``_bwd_pair`` over kv halves with the global LSE and Δ
               (non-causal: dq sums, dk/dv concatenate; causal: the two-device
               ring layout); and b*H = 65538 (past grid.y's limit) at s=8,
               D=64, f32 and bf16, forward and pair, whose last two heads
               are held against the plain version with the heads before as
               the planted fault.  Limits: bf16/f16 ``FLASH_TOL``; f32
               ``FLASH_F32_TOL`` (relative L2 1e-4, worst row 2e-3, LSE 1e-5),
               which TF32 products fail.  Each case reads a control (the plain
               version in the input's dtype, must pass) and a planted fault (a
               stale kv tile, must fail); each f32 case also the plain version
               on operands rounded to TF32 (must fail), and runs the forward
               twice more, bit for bit the same; at D <= 256 with rows TMA
               addresses (the 3xTF32 forward) it reads O's error beside the
               plain forward on 3xTF32 operands split to nearest and by
               truncation.  Each f32 case at
               D <= 256 also holds the dK/dV + dQ pair (3xTF32 on the tensor
               cores) to ``FLASH_F32_PAIR_REL`` (relative L2 6e-7 on dq, dk
               and dv against f64) and runs it three times more: bit for
               bit the same; beside it the plain pair on 3xTF32 operands
               split to nearest (read) and split by truncation (the
               control, must fail the limit).
7. flash_bhd -- K2's times at the f32 training geometry by CUDA-graph
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
               the f32 kernels at D=256 (b=8, s=1024, H=4) beside their
               bounds, plain versions and SDPA (``wide``); the pair's error
               against f64 beside SDPA's own f32 backward's.
8. train_f32 -- GPT-2-small f32 (``make_sharded_train_step`` with no
               ``param_dtype``: f32 parameters and Adam moments) at b=16,
               s=1024, flash on auto: 2 warm-up and 10 timed steps.  Gates:
               losses finite and falling, K2 launches exactly 10 x 12 each,
               K1 launches 0, no plain K2 call.  Then one profiled step
               (``train_f32_profile``: idle share, K2's share of busy
               time) and a 3-step loss series at b=4, K2 against
               ``use_flash_attention=False`` (the plain composition), rtol
               ``F32_FLASH_VS_PLAIN_RTOL``.
9. wide     -- a GPT at D = 256 (hidden 1024, 4 heads, 2 layers), b=4,
               s=1024, 3 train steps each way: bf16 through K1, f32
               through SDPA and K2.  Gates: the flash series' launches
               exactly 3 x 2 per kernel, the other family's and the plain
               versions' calls 0, and its loss series against the plain
               composition's within ``FLASH_VS_PLAIN_RTOL`` (bf16) and
               ``F32_FLASH_VS_PLAIN_RTOL`` (f32).
9b. wide512 -- the same at D = 512 (hidden 1024, 2 heads, 2 layers, b=2,
               s=1024): K1 and K2 through their column-chunked kernels.
               Then (``wide512_times``) those kernels timed at its
               attention (b=2, H=2, s=1024, D=512; K2 f32, K1 bf16) and
               K3 at D=512 (widths 1 and 32, bf16), each beside its plain
               version, SDPA and its bounds.
10. paged   -- holds ``paged_attention`` (K3: the split decode kernel at
               widths below 16 with 16-byte rows up to D=256, else the
               tile kernels) against its plain PyTorch version
               (``paged_attention_ref``) at the serving geometry (B=16,
               H=12, D=64, P=16, maxp=32; widths 1 and 32; shuffled page
               tables, an inactive slot, lengths 0 / page boundary / last
               row of the table; and the serving run's own pool, tables
               and lengths), and past the old limits: widths 65, 128 (pages
               of 128) and 256 (pages of 256), width 1 over pages of 128,
               D=36, and D=320 and 512 at widths 1 and 32 over 8-page
               tables (bf16 widths from 16 run the tensor-core kernel, the
               rest the scalar one; past 256 both take the width in
               slices), each beside a control (the plain version in the
               inputs' dtype, must pass) and a planted fault (each slot's
               first page read from its second, must fail): bf16 against
               an f32 run of the plain
               version at atol=rtol=2e-2, f32 at 2e-5 with TF32 off.  Then
               the split decode kernel at widths 1 and 15, pages of 16, 128
               and 512, D = 64, 128 and 256, in bf16, f16 (its control the
               f32 result rounded to f16: f16 cannot hold the -1e30 mask)
               and f32; 65538 slots of one page each (widths 1 and 16, bf16
               and f32: the last two slots against the plain version, the
               two before as the planted fault); and its summation order:
               three runs bit for bit, each of 16 slots alone bit for bit
               as among the 16 (the fault: a slot alone against its
               neighbour must differ).  Times the
               kernel, the plain version and
               ``F.scaled_dot_product_attention`` on the gathered
               contiguous K/V (a yardstick the port never calls) at the
               serving run's decode and chunk inputs and at the table's
               full length, by CUDA-graph replay over input copies larger
               than the L2, beside the byte bound and, for decode, the
               tile kernels' entry point (the scalar kernel, which ran the
               decode steps before); and at width 128 over pages of
               128 beside its bound, plain version and SDPA with the
               offset-causal mask over the gathered K/V.
11. serving -- GPT-2-small in bf16 through
               ``ServingEngine(cache_mode="paged", max_slots=16, max_len=512,
               page_size=16, num_pages=257, chunk=32, decode_window=32)``:
               16 greedy requests of 64 prompt tokens and 128 new tokens.
               Every request must finish, the split decode kernel's launch
               count must equal the decode steps times the layers and the
               tile kernels' the chunk ticks times the layers, the plain
               version must not be called, and the pool must drain.  Then
               an f32 run of 4 requests x 32 new tokens must be
               token-exact against the dense engine (the plain static-cache
               path), or diverge only at a logit margin <= 1e-3.
12. profile -- device time by kernel over one short serving run
               (``torch.profiler``), for the breakdown in PERF.md, with
               K3's kernels' share of the busy time.
13. paged_wide -- the paged engine at ``chunk=128, page_size=128`` against
               the dense engine, GPT-2-small f32, 4 requests of 300, 200,
               150 and 64 prompt tokens x 32 new: token-exact, K3 launched,
               no page in use after the run.
14. quant_checks -- holds the dequant-GEMM kernel K4
               (``csrc/quant_matmul.cu``) against its plain version
               ``quant_matmul_ref`` on the card: the four GPT-2-small
               projections (K, N) = (768, 2304), (768, 768), (768, 3072),
               (3072, 768) x M in {1, 8, 200, 256} x int8 / fp8-e4m3
               weights (quantized by ``nn.quant.quantize_array``), bf16
               activations; the reading is the largest error in bf16 ulps
               of the reference, limit 1 (the JAX contract), each output's
               ulp floored at its f32 accumulation noise (``sum_noise``:
               outputs that cancel to near zero), with the raw reading
               beside it.  Each case also
               reads a control (the plain version with K summed in reverse
               128-row chunks, which must pass) and a planted fault (the
               kernel on a weight whose second 128-row K tile is a copy of
               its first, which must fail), and row 0 and row 255 of M = 256
               must equal, bit for bit, the same rows computed alone.  f32
               activations at (8, 768, 2304): relative error <= 1e-5 of
               max|ref|; f16 activations at the same shape: 1 f16 ulp.  A
               3-D input with bias through ``quant_matmul``.
15. quant   -- K4's time at M = 8 and M = 256 for each projection, by
               CUDA-graph replay over input copies larger than the L2
               (> 60 MB, >= 24 copies), beside its bound, the plain
               version's time and a library yardstick the port never calls
               (``torch._weight_int8pack_mm`` where this torch runs it on
               CUDA, else the bf16 cuBLAS product ``x @ w_bf16``, labelled).
16. serving_int8 -- the JAX package's ``serving_int8`` row on the card:
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
17. quant_f32_cross_check -- int8 and fp8 artifacts of the f32 model: the
               dense and paged engines token-exact against the same
               quantized model's greedy ``generate`` on the card, 4 requests
               x 32 new tokens.

Then the kernel table line, the ``nvidia-smi`` line, and last the result
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the result line; without a CUDA device it exits 2.
"""

import json
import re
import subprocess
import sys
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


def serving_case(torch, width, seed):
    """Inputs as the serving run gives them: the engine's pool of 257 pages,
    16 slots owning 14 shuffled pages each (the rest of each 32-page table
    row NULL); width 1 at decode lengths 64..191, width 32 at the two
    prefill-chunk offsets 0 and 32."""
    B, H, D, P, maxp, N, own = 16, 12, 64, 16, 32, 257, 14
    rng = np.random.RandomState(seed)
    pt = np.zeros((B, maxp), np.int32)
    pt[:, :own] = (rng.permutation(N - 1) + 1)[:B * own].reshape(B, own)
    if width == 1:
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


def tiles_route(torch, pa, c):
    """The tile kernels' entry point on a case: the scalar kernel at decode
    widths, which ran the decode steps before the split decode kernel.
    Timed beside it; a comparison, not counted as a launch."""
    q = c["q"]
    B, s, H, D = q.shape
    N, P = c["k_pool"].shape[:2]
    out = torch.empty_like(q)
    err = pa._lib("paged_attention")(
        pa._DTYPE_CODES[q.dtype], q.data_ptr(), c["k_pool"].data_ptr(),
        c["v_pool"].data_ptr(), c["page_table"].data_ptr(),
        c["lengths"].data_ptr(), out.data_ptr(), B, s, H, D, N, P,
        c["page_table"].shape[1], 1.0 / D ** 0.5,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"paged_attention_launch: CUDA error {err}")
    return out


# the split decode kernel's cases: pages of 16, 128 and 512, each table
# 512-1024 rows long
SPLIT_PAGES = ((16, 32), (128, 4), (512, 2))


def many_slots_case(torch, dtype, width, seed, B=65538, H=2, D=64, P=16):
    """B slots of one page each (slot b on page b + 1; page 0 the NULL
    page), lengths up to the page's last row: past grid.y's 65535."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    mk = lambda *sh: torch.randn(*sh, generator=gen,  # noqa: E731
                                 device=DEV).to(dtype)
    lengths = torch.randint(0, P - width + 1, (B,), generator=gen,
                            device=DEV, dtype=torch.int32)
    return dict(q=mk(B, width, H, D), k_pool=mk(B + 1, P, H, D),
                v_pool=mk(B + 1, P, H, D),
                page_table=torch.arange(1, B + 1, device=DEV,
                                        dtype=torch.int32)[:, None],
                lengths=lengths)


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
        from its second, which must fail)."""
        out = pa.paged_attention_kernel(**case)
        torch.cuda.synchronize()
        f32 = {k: v.float() if v.is_floating_point() else v
               for k, v in case.items()}
        ref32 = pa.paged_attention_ref(**f32)
        bad = dict(f32, page_table=case["page_table"].clone())
        bad["page_table"][:, 0] = bad["page_table"][:, 1]
        within = within_of(ref32, tol)
        err = (out.float() - ref32).abs()
        # f16 cannot hold the plain version's -1e30 mask: its control is
        # the f32 result rounded to f16
        control = (pa.paged_attention_ref(**case)
                   if out.dtype != torch.float16 else ref32.half())
        ok = (within(out) and within(control)
              and not within(pa.paged_attention_ref(**bad)))
        B, s, _, D = case["q"].shape
        rec = {"case": name, "kernel": (
                   "split" if pa.uses_split_decode(s, D, out.dtype)
                   else "tiles"),
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
        # past 256: the width in slices (decode steps and the tensor-core
        # prefill kernel alike)
        for D in (320, 512):
            for width in (1, 32):
                check(f"{tag}_d{D}_w{width}",
                      kernel_case(torch, dtype, width, seed=D + width, D=D,
                                  maxp=8), tol)
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
        torch.cuda.empty_cache()

    # slots past 65535 (grid.y's limit): the last two slots against the
    # plain version, the planted fault the plain version of the two
    # before, as a kernel that wrapped the slot index would read them
    for dtype, width, tol in ((torch.bfloat16, 1, 2e-2),
                              (torch.float32, 1, 2e-5),
                              (torch.bfloat16, 16, 2e-2),
                              (torch.float32, 16, 2e-5)):
        case = many_slots_case(torch, dtype, width, seed=width)
        out = pa.paged_attention_kernel(**case)
        B = case["q"].shape[0]
        part = lambda sl, c=case: dict(  # noqa: E731
            c, q=c["q"][sl].contiguous(),
            page_table=c["page_table"][sl].contiguous(),
            lengths=c["lengths"][sl].contiguous())
        tail, before = part(slice(B - 2, B)), part(slice(B - 3, B - 1))
        f32 = lambda c: {k: v.float() if v.is_floating_point() else v  # noqa
                         for k, v in c.items()}
        ref32 = pa.paged_attention_ref(**f32(tail))
        within = within_of(ref32, tol)
        got = out[B - 2:]
        ok = (within(got) and within(pa.paged_attention_ref(**tail))
              and not within(pa.paged_attention_ref(**f32(before))))
        tag = str(dtype).split('.')[-1]
        checks.append({"case": f"b65538_{tag}_w{width}", "ok": ok,
                       "kernel": ("split" if width == 1 else "tiles"),
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
                                                    seed=9, P=128, maxp=4))):
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

    def times(case, plain_reps=5, old=False):
        """The kernel, the plain version, SDPA on the gathered K/V and (old)
        the tile kernels' entry point, over input copies larger than the
        L2, beside the bound."""
        cs = copies(case)
        row = {"ms": device_ms(torch, [
                   lambda c=c: pa.paged_attention_kernel(**c) for c in cs]),
               "plain_ms": device_ms(torch, [
                   lambda c=c: pa.paged_attention_ref(**c) for c in cs],
                   reps=plain_reps)}
        libs = [gathered(torch, c) for c in cs]
        row["library_ms"] = device_ms(torch, [lambda a=a: lib(a)
                                              for a in libs])
        row["library_vs_kernel_max_abs"] = float(
            (lib(libs[0]).transpose(1, 2).float()
             - pa.paged_attention_kernel(**case).float()).abs().max())
        if old:
            row["tiles_route_ms"] = device_ms(torch, [
                lambda c=c: tiles_route(torch, pa, c) for c in cs])
            row["tiles_route_max_abs_vs_kernel"] = float(
                (tiles_route(torch, pa, case).float()
                 - pa.paged_attention_kernel(**case).float()).abs().max())
        row["bound_ms"], row["bound_by"] = bound(case, 2, H100_BF16_FLOPS)
        del cs, libs
        torch.cuda.empty_cache()
        return row

    case = serving_case(torch, 1, seed=1)
    err = check("bfloat16_w1_serving", case, 2e-2)
    wide = serving_case(torch, 32, seed=32)
    err_w32 = check("bfloat16_w32_serving", wide, 2e-2)
    decode = times(case, old=True)
    chunk = times(wide)
    maxlen = times(kernel_case(torch, torch.bfloat16, 1, seed=1), old=True)
    # a 128-row prefill chunk over pages of 128 (the wide paged engine's),
    # beside SDPA with the offset-causal mask over the gathered K/V
    w128 = times(kernel_case(torch, torch.bfloat16, 128, seed=129, P=128,
                             maxp=4), plain_reps=2)
    emit({"phase": "paged", "checks": checks, "invariance": invariance,
          "decode_w1_serving": decode, "chunk_w32_serving": chunk,
          "decode_w1_maxlen": maxlen, "chunk_w128_p128": w128})
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return ({"max_abs_err": err, **{k: decode[k] for k in keys},
             "tiles_route_ms": decode["tiles_route_ms"],
             "maxlen": {k: maxlen[k] for k in keys + ("tiles_route_ms",)}},
            {"max_abs_err": err_w32, **{k: chunk[k] for k in keys}})


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
        ref = flash_plain(fap, qkv.float(), cot.float(), *args)
        got = {"kernel": flash_slices(out, lse, x.grad, H),
               "control": flash_plain(fap, qkv, cot, *args),
               "fault": flash_plain(fap, stale_tile(qkv, H), cot, *args)}
        r = {k: flash_readings(v, ref) for k, v in got.items()}
        ok = (flash_within(r["kernel"]) and flash_within(r["control"])
              and not flash_within(r["fault"]) and bitwise)
        # [LSE, then (rel, row) for O, dQ, dK, dV]: a short line
        checks.append({"case": name, "ok": ok, "bitwise_repeat": bitwise,
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
    # past 256: the column-chunked kernels (D = 320 in three 128-column
    # chunks, the last half empty; D = 512 in four)
    check("d320_h2", 2, 256, 2, 320, True)
    check("d512_h1", 2, 256, 1, 512, True)
    check("d512_h2_noncausal_dropout0.1", 1, 256, 2, 512, False, p=0.1,
          seed=5)

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
    # the in-call yardstick of the mma.sync design: K2's bf16 dK/dV and dQ
    # at the same shape, on the split heads
    qb, kb, vb = (t.reshape(b, s, H, D).transpose(1, 2)
                  .reshape(b * H, s, D).contiguous()
                  for t in qkv.split(H * D, -1))
    dob = dout.reshape(b, s, H, D).transpose(1, 2).reshape(
        b * H, s, D).contiguous()
    o2, lse2 = fa.flash_fwd_kernel(qb, kb, vb, True, scale)
    d2 = (dob.float() * o2.float()).sum(-1)
    k2_pair = 2 * device_ms(torch, [
        lambda: fa.flash_dkdv_kernel(qb, kb, vb, dob, lse2, d2, True, scale),
        lambda: fa.flash_dq_kernel(qb, kb, vb, dob, lse2, d2, True, scale)])
    del qb, kb, vb, dob, o2, lse2, d2
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
              "k2_bf16_backward_ms": k2_pair,
              "over_sdpa": pair / lib_bwd, "over_k2": pair / k2_pair,
              "bitwise_repeat": bitwise},
          "fwd_over_sdpa": ms["fwd"] / lib_fwd,
          "wide": wide})
    for k in rows:
        rows[k]["wide_d256"] = {key: wide["timing"][k][key] for key in
                                ("ms", "bound_ms", "bound_by", "library_ms")}
    return rows


WIDE_SHAPE = dict(b=8, s=1024, H=4, D=256)   # the wide GPT's attention


def flash_wide_times(torch, fap, F):
    """K1's three kernels at ``WIDE_SHAPE`` (D = 256, causal) by graph
    replay, beside their bounds, the plain versions and the library's bf16
    SDPA forward and backward on pre-split heads; the timed results held
    against the plain version in f32."""
    import math
    b, s, H, D = (WIDE_SHAPE[k] for k in "bsHD")
    scale = 1.0 / math.sqrt(D)
    qkv, dout = flash_case(torch, b, s, H, D, torch.bfloat16, seed=101)
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
    ref = flash_plain(fap, qkv.float(), dout.float(), H, True, scale)
    readings = flash_readings(flash_slices(out, lse, dqkv, H), ref)
    del ref
    torch.cuda.empty_cache()
    if not flash_within(readings):
        raise AssertionError(f"flash kernels disagree with their plain "
                             f"versions at {WIDE_SHAPE}: {readings}")
    qh, kh, vh = (t.reshape(b, s, H, D).transpose(1, 2).contiguous()
                  .requires_grad_(True) for t in qkv.split(H * D, -1))
    doh = dout.reshape(b, s, H, D).transpose(1, 2).contiguous()
    with torch.no_grad():
        lib_fwd = device_ms(torch, [lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True)])
    og = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
    lib_bwd = profiled_ms(torch, lambda: torch.autograd.grad(
        og, (qh, kh, vh), doh, retain_graph=True))
    del og, qh, kh, vh, doh
    e = 2
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
    timing = {}
    for k in ("fwd", "dkdv", "dq"):
        b_ms, b_by, flops, _ = bounds[k]
        timing[k] = {"ms": ms[k], "plain_ms": plain[k], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib[k],
                     "tflops": flops / ms[k] / 1e9}
    del qkv, dout, out, lse, delta, dqkv
    torch.cuda.empty_cache()
    return {"shape": WIDE_SHAPE, "causal": True, "readings": readings,
            "timing": timing}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def profile_summary(torch, prof, wall):
    """Device busy time and idle share over ``wall``, and the top device
    kernels and host ops, from a ``torch.profiler`` run."""
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
    return {"wall_s": wall,
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
# the first two (1e-6 let most truncated readings pass).
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
        if f32 and D <= 256:
            # the 3xTF32 pair's own limit, and its repeats bit for bit
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
            ok = (ok and pair_rel <= FLASH_F32_PAIR_REL and same
                  and emu["trunc"] > FLASH_F32_PAIR_REL)
            extra.update({"pair_rel": pair_rel, "pair_bitwise_repeat": same,
                          "split_rna_rel": emu["rna"],
                          "split_trunc_rel": emu["trunc"]})
            del runs
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
        # past 256 the column-chunked kernels (D = 264: a 8-column third
        # chunk; 320; 512)
        for D in (32, 80, 128, 256, 36, 264, 320, 512):
            check(f"{tag}_d{D}", 8, 256, 256, D, True, dt)
        check(f"{tag}_ring_kv_halves", 8, 512, 512, 64, False, dt,
              ring=True)
    check("f32_ring_causal", 8, 512, 512, 64, True, f32, ring=True)
    # rows TMA cannot address (33 f32 = 132 bytes): the column-chunked
    # kernels at a width the 3xTF32 pair does not take
    check("f32_d33", 8, 256, 256, 33, True, f32)
    check("f32_d264_dropout0.1_sq256_skv512", 4, 256, 512, 264, True, f32,
          0.1, 77)
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
        out, lse = fa.flash_fwd_kernel(q, k, v, True, scale)
        delta = (do.float() * out.float()).sum(-1)
        grads = fa._bwd_pair(q, k, v, do, lse, delta, True, scale)
        torch.cuda.synchronize()
        tail, before = slice(bh - 2, bh), slice(bh - 3, bh - 1)
        f32 = dtype == torch.float32
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
              and not (f32 and flash_within(r["tf32"], tol)))
        checks.append({"case": name, "ok": ok, **{
            key: [val["lse"]] + [val[sl][m] for sl in FLASH_SLICES
                                 for m in ("rel", "row")]
            for key, val in r.items()}})
        del q, k, v, do, out, lse, delta, grads, ref, got

    check_many_heads("f32_bh65538_s8_d64", f32)
    check_many_heads("bf16_bh65538_s8_d64", bf16)
    torch.cuda.empty_cache()
    emit({"phase": "flash_bhd_checks",
          "tolerances": {"f32": FLASH_F32_TOL, "bf16_f16": FLASH_TOL,
                         "f32_pair_rel_d_le_256": FLASH_F32_PAIR_REL},
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
    emit({"phase": "flash_bhd", "shape": BHD_TRAIN_SHAPE, "dtype": "float32",
          "causal": True, "timing": timing, "backward_pair": pair_row,
          "library": {"call": "F.scaled_dot_product_attention(is_causal=True)"
                              " on (b, H, s, D) f32",
                      "backend": str(backend), "readings_vs_f64": lib_read},
          "plain_note": "dkdv and dq share one plain backward and one "
                        "library backward (each computes dq, dk, dv)",
          "bf16_beside_k1": {"shape": TRAIN_SHAPE, "ms": bf16,
                             "k1_vs_k2_out_max_abs": same_out},
          "wide": wide})
    return rows


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
    3 x 2 each, the other family's 0, the plain versions called 0 times;
    the flash and plain-composition loss series within the bf16 / f32
    limits."""
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
            for counts in (fa.launches, fap.launches):
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
                            "other_launches": dict(other.launches),
                            "plain_calls": calls}
            del model, step, state
            torch.cuda.empty_cache()
        rel = max(abs(x - y) / abs(y) for x, y in
                  zip(series["flash"]["losses"], series["plain"]["losses"]))
        report[tag] = dict(series, max_rel_diff=rel, rtol=rtol)
        need = steps * gpt["num_layers"]
        f = series["flash"]
        if (any(n != need for n in f["launches"].values())
                or any(f["other_launches"].values())
                or any(f["plain_calls"].values())
                or any(series["plain"]["launches"].values())):
            raise AssertionError(f"{name} {tag}: the flash series did not "
                                 f"run its kernels exactly {need} times each "
                                 f"(or ran the other family, or a plain "
                                 f"version): {series}")
        if not all(np.isfinite(f["losses"])) or not rel <= rtol:
            raise AssertionError(f"{name} {tag}: flash and plain loss "
                                 f"series differ by {rel} > {rtol}: "
                                 f"{series}")
    emit({"phase": name, "model": gpt,
          "head_dim": gpt["hidden_size"] // gpt["num_heads"],
          "batch": b, "seq": s, "steps": steps, **report})


WIDE512_SHAPE = dict(b=2, s=1024, H=2, D=512)   # the wide512 GPT's heads


def wide512_times(torch, fa, fap, pa):
    """The column-chunked kernels at the wide512 GPT's attention (D = 512,
    b=2, H=2, s=1024, causal) by graph replay: K2 in f32 and K1 in bf16
    beside their plain versions, SDPA (default backend) and two bounds
    each (the tensor cores at the inputs' type, and the CUDA cores' f32
    rate these kernels run at); K3 at D = 512 (16 slots, 12 heads, 8 pages
    of 16) at width 1 and a chunk of 32, bf16, beside its plain version
    and SDPA on the gathered K/V."""
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
    del q, k, v, do, o, lse, delta, qh, kh, vh, doh, xs, og
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
    del qkv, dout, o, lse, delta, dqkv, qh, kh, vh, doh, og
    torch.cuda.empty_cache()

    out["k3_bf16"] = {}
    for width in (1, 32):
        case = kernel_case(torch, torch.bfloat16, width, seed=514 + width,
                           D=D, maxp=8)
        cs = copies(case)
        libs = [gathered(torch, c) for c in cs]
        b_ms, b_by = bound(case, 2, H100_BF16_FLOPS)
        out["k3_bf16"][f"w{width}"] = {
            "ms": device_ms(torch, [lambda c=c: pa.paged_attention_kernel(**c)
                                    for c in cs]),
            "plain_ms": device_ms(torch, [
                lambda c=c: pa.paged_attention_ref(**c) for c in cs],
                reps=2),
            "library_ms": device_ms(torch, [
                lambda a=a: F.scaled_dot_product_attention(
                    a[0], a[1], a[2], attn_mask=a[3]) for a in libs]),
            "bound_ms": b_ms, "bound_by": b_by}
        del cs, libs, case
        torch.cuda.empty_cache()
    return {"shape": WIDE512_SHAPE, "k3_geometry": "16 slots, 12 heads, "
            "D=512, pages of 16, 8 a slot", **out}


def random_weights(model, seed):
    """Normal(0, 0.02) matrices, zero biases, unit layer-norm scales, as the
    JAX model initialises them, keyed by the JAX state-dict names."""
    rng = np.random.default_rng(seed)
    arrays = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith(".bias"):
            arrays[name] = np.zeros(shape, np.float32)
        elif ".ln_" in name:
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
    eng = ServingEngine(model, cache_mode="paged", **eng_kw)
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
        for k in pa.launches:
            pa.launches[k] = 0
        plain["paged_attention_ref"] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, 128) for p in prompts]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(pa.launches)
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
        assert plain["paged_attention_ref"] == 0, plain
        eng.drop_prefix_cache()
        assert eng.kv_pages_in_use == 0, eng.kv_pages_in_use
        ttft = sorted(r.ttft_s for r in reqs)
        runs.append({"wall_s": wall, "tokens_per_s": 16 * 128 / wall,
                     "ttft_p50_s": ttft[len(ttft) // 2],
                     "ttft_max_s": ttft[-1], "decode_ticks": decode_ticks,
                     "chunk_ticks": chunk_ticks, "kernel_launches": launches,
                     "plain_calls": plain["paged_attention_ref"]})
    restore(pa, real)
    med = sorted(runs, key=lambda r: r["wall_s"])[1]
    emit({"phase": "serving", "model": "gpt2-small-en bf16",
          "requests": 16, "prompt": 64, "new_tokens": 128,
          "median": med, "runs": runs, "kv_pages_in_use": 0})
    launches = runs[0]["kernel_launches"]

    # f32: the paged engine (kernel) against the dense engine (the plain
    # static-cache path) on the same weights
    m32 = GPTForCausalLM(cfg, device=DEV)
    load_jax_state(m32, arrays)
    outs = {}
    for mode in ("paged", "dense"):
        e = ServingEngine(m32, cache_mode=mode, **eng_kw)
        rs = [e.submit(p, 32) for p in prompts[:4]]
        e.run_until_idle()
        outs[mode] = [r.result() for r in rs]
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
          "token_exact": exact, "divergences": margins})
    return eng, prompts, launches


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
        eng = ServingEngine(model, cache_mode=mode, **kw, **extra)
        for k in pa.launches:
            pa.launches[k] = 0
        reqs = [eng.submit(p, 32) for p in prompts]
        eng.run_until_idle()
        outs[mode] = [r.result() for r in reqs]
        stats[mode] = {"k3_launches": dict(pa.launches),
                       "chunk_ticks": eng.stats["chunk_ticks"],
                       "decode_ticks": eng.stats["decode_ticks"]}
        if mode == "paged":
            eng.drop_prefix_cache()
            stats[mode]["kv_pages_in_use"] = eng.kv_pages_in_use
        del eng
    exact = sum(bool(np.array_equal(a, b))
                for a, b in zip(outs["paged"], outs["dense"]))
    emit({"phase": "paged_wide", "chunk": 128, "page_size": 128,
          "requests": 4, "new_tokens": 32, "token_exact_of_4": exact,
          **stats})
    p = stats["paged"]
    if exact != 4 or not all(p["k3_launches"].values()) \
            or p["kv_pages_in_use"] != 0 \
            or any(stats["dense"]["k3_launches"].values()):
        raise AssertionError(f"paged engine at chunk 128 / pages of 128: "
                             f"{exact} of 4 token-exact against dense, "
                             f"{stats}")
    del model
    torch.cuda.empty_cache()


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


def phase_quant_checks(torch, qm, wo):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, bad, max_abs = [], [], 0.0
    for name, (k, n) in QUANT_SHAPES.items():
        for scheme in ("int8", "fp8"):
            for m in (1, 8, 200, 256):
                c = quant_case(torch, wo, m, k, n, scheme, torch.bfloat16,
                               seed=m + k + n)
                out = qm.quant_matmul_kernel(*c.values())
                torch.cuda.synchronize()
                ref = qm.quant_matmul_ref(*c.values())
                stale = c["w_q"].clone()
                stale[128:256] = c["w_q"][:128]       # a stale K tile
                fault = qm.quant_matmul_kernel(c["x2d"], stale, c["scale"])
                noise = sum_noise(torch, *c.values())
                r = [bf16_ulps(torch, out, ref, noise),
                     bf16_ulps(torch, reversed_chunks_ref(torch, **c), ref,
                               noise),
                     bf16_ulps(torch, fault, ref, noise),
                     bf16_ulps(torch, out, ref)]
                case = f"{name}_{scheme}_m{m}"
                ok = (r[0] <= QUANT_ULP_LIMIT and r[1] <= QUANT_ULP_LIMIT
                      and r[2] > QUANT_ULP_LIMIT
                      and bool(torch.isfinite(out).all()))
                if m == 256:
                    # the rows' sums do not depend on M or on the tile
                    alone = [qm.quant_matmul_kernel(c["x2d"][i:i + 1],
                                                    c["w_q"], c["scale"])
                             for i in (0, 255)]
                    inv = (torch.equal(alone[0][0], out[0])
                           and torch.equal(alone[1][0], out[255]))
                    r.append(inv)
                    ok = ok and inv
                max_abs = max(max_abs, float((out.float() - ref.float())
                                             .abs().max()))
                rows.append([case] + r)
                if not ok:
                    bad.append(case)
    # f32 activations, and a 3-D input with bias through the dispatch
    f32 = {}
    for scheme in ("int8", "fp8"):
        c = quant_case(torch, wo, 8, 768, 2304, scheme, torch.float32, 7)
        ref = qm.quant_matmul_ref(*c.values())
        rel = float((qm.quant_matmul_kernel(*c.values()) - ref).abs().max()
                    / ref.abs().max())
        f32[scheme] = rel
        if not rel <= QUANT_F32_REL:
            bad.append(f"f32_{scheme}")
    f16 = {}
    for scheme in ("int8", "fp8"):    # f16 activations, in f16 ulps
        c = quant_case(torch, wo, 8, 768, 2304, scheme, torch.float16, 8)
        f16[scheme] = bf16_ulps(torch, qm.quant_matmul_kernel(*c.values()),
                                qm.quant_matmul_ref(*c.values()),
                                sum_noise(torch, *c.values()), bits=10)
        if not f16[scheme] <= QUANT_ULP_LIMIT:
            bad.append(f"f16_{scheme}")
    c = quant_case(torch, wo, 8, 768, 2304, "int8", torch.bfloat16, 9)
    bias = torch.randn(2304, device=DEV)
    x3 = c["x2d"].reshape(2, 4, 768)
    got = qm.quant_matmul(x3, c["w_q"], c["scale"], bias)
    kern = qm.quant_matmul_kernel(*c.values())
    three_d = (tuple(got.shape) == (2, 4, 2304) and torch.equal(
        got, (kern + bias.to(torch.bfloat16)).reshape(2, 4, 2304))
        and bf16_ulps(torch, kern, qm.quant_matmul_ref(*c.values()),
                      sum_noise(torch, *c.values())) <= QUANT_ULP_LIMIT)
    if not three_d:
        bad.append("3d_bias")
    emit({"phase": "quant_checks", "limit_ulps": QUANT_ULP_LIMIT,
          "fields": ["case", "kernel_ulps", "control_ulps", "fault_ulps",
                     "kernel_raw_ulps (no floor)",
                     "rows_0_255_equal_alone (m256)"],
          "checks": rows, "f32_rel_err": f32, "f32_limit": QUANT_F32_REL,
          "f16_ulps": f16,
          "bias_3d_ok": three_d, "max_abs_err": max_abs})
    if bad:
        raise AssertionError(f"quant_matmul kernel disagrees with its plain "
                             f"version, or the limit does not separate the "
                             f"control from the planted fault: {bad}")
    return max_abs


def quant_bound(m, k, n):
    """Least time for one product: x, w_q, scale and out moved once, or
    2 M K N flops at the bf16 tensor-core peak, whichever is larger."""
    nbytes = m * k * 2 + k * n + n * 4 + m * n * 2
    flops = 2 * m * k * n
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
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


def phase_quant(torch, qm, wo):
    int8pack = int8pack_runs(torch)
    timing, decode = {}, {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                          "library_ms": 0.0, "bound_by": "bytes"}
    for name, (k, n) in QUANT_SHAPES.items():
        for m in (8, 256):
            c = quant_case(torch, wo, m, k, n, "int8", torch.bfloat16, m + n)
            per_copy = sum(t.numel() * t.element_size() for t in c.values())
            cases = copies(c, max(24, -(-60_000_000 // per_copy)))
            k_ms = device_ms(torch, [
                lambda c=c: qm.quant_matmul_kernel(*c.values())
                for c in cases])
            p_ms = device_ms(torch, [
                lambda c=c: qm.quant_matmul_ref(*c.values())
                for c in cases], reps=2)
            l_ms = lib_err = None
            if int8pack:    # weight transposed once, outside the timing
                libs = [(c["x2d"], c["w_q"].t().contiguous(),
                         c["scale"].to(torch.bfloat16)) for c in cases]
                lib_err = float((torch._weight_int8pack_mm(*libs[0]).float()
                                 - qm.quant_matmul_kernel(*c.values())
                                 .float()).abs().max())
                l_ms = device_ms(torch, [
                    lambda a=a: torch._weight_int8pack_mm(*a) for a in libs])
                del libs
            # what the unquantized bf16 row runs instead (no library call
            # of K4's function): cuBLAS on bf16 weights of the same shape
            wides = [(c["x2d"], (c["w_q"].float() * c["scale"]).to(
                torch.bfloat16)) for c in cases]
            bf16_ms = device_ms(torch, [lambda a=a: a[0] @ a[1]
                                        for a in wides])
            del cases, wides
            b_ms, b_by = quant_bound(m, k, n)
            timing[f"{name}_m{m}"] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
                "library_vs_kernel_max_abs": lib_err,
                "bf16_cublas_ms": bf16_ms,
                "bound_ms": b_ms, "bound_by": b_by,
                "gbytes_per_s": (m * k * 2 + k * n + n * 4 + m * n * 2)
                / k_ms / 1e6}
            if m == 8:
                for key, v in (("ms", k_ms), ("plain_ms", p_ms),
                               ("bound_ms", b_ms), ("library_ms", l_ms)):
                    decode[key] = None if v is None or decode[key] is None \
                        else decode[key] + v
                if b_by != "bytes":
                    decode["bound_by"] = "operations"
    torch.cuda.empty_cache()
    emit({"phase": "quant", "weights": "int8", "activations": "bf16",
          "library": "torch._weight_int8pack_mm" if int8pack else None,
          "timing": timing, "decode_layer_m8": dict(decode, note="sum of the four "
                                  "projections of one layer at M=8")})
    return decode


def weight_bytes(model):
    """Bytes the decode tick reads as weights: params (quant scales
    included) + buffers, as the JAX ``serving_weight_bytes`` gauge counts
    them."""
    return (sum(p.numel() * p.element_size() for p in model.parameters())
            + sum(b.numel() * b.element_size() for b in model.buffers()))


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


def median_run(runs):
    return sorted(runs, key=lambda r: r["wall_s"])[len(runs) // 2]


def phase_serving_int8(torch, qm):
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from paddle_hackathon_tpu_torch.inference import (ServingEngine,
                                                      load_for_serving,
                                                      save_for_serving)
    from paddle_hackathon_tpu_torch.models import GPTForCausalLM, gpt_config
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
    bytes_ = {"bf16": weight_bytes(bf16), "int8": weight_bytes(int8)}
    engines = {"bf16": ServingEngine(bf16, **SERVE_INT8),
               "int8": ServingEngine(int8, **SERVE_INT8)}
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
    del engines, bf16, int8
    torch.cuda.empty_cache()
    return launches, arrays, prompts


def phase_quant_f32_cross_check(torch, arrays, prompts):
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
            e = ServingEngine(mq, cache_mode=mode, **SERVE_INT8)
            rs = [e.submit(p, 32) for p in prompts[:4]]
            e.run_until_idle()
            same = [bool(np.array_equal(r.result(), ref[i]))
                    for i, r in enumerate(rs)]
            res[f"{scheme}_{mode}"] = sum(same)
            if not all(same):
                bad.append(f"{scheme}_{mode}")
        del mq
    emit({"phase": "quant_f32_cross_check", "requests": 4, "new_tokens": 32,
          "token_exact_of_4": res})
    if bad:
        raise AssertionError(f"quantized f32 engines diverge from the same "
                             f"model's generate: {bad}")
    del m32
    torch.cuda.empty_cache()


K1_KERNEL = re.compile(
    r"(flash_packed_(?:fwd|dkdv|dq)_kernel)I(13__nv_bfloat16|6__half)Li(\d+)E")
K1_SMEM_INDEX = {"fwd": 0, "dkdv": 1, "dq": 2}


def k1_kernel_name(mangled):
    """``flash_packed_dkdv_kernel<bf16,64>`` from a mangled K1 kernel
    name, or None for any other function."""
    m = K1_KERNEL.search(mangled)
    if not m:
        return None
    dtype = "bf16" if "bfloat16" in m.group(2) else "f16"
    return f"{m.group(1)}<{dtype},{m.group(3)}>"


def k1_build(_build, libs):
    """Each K1 kernel's (forward, dK/dV, dQ; bf16/f16; 64/128/256 wide)
    registers, spills, ptxas performance notes and dynamic shared memory,
    and where cuobjdump is found, its count of HGMMA (wgmma)
    instructions, which must be above 0 for all 18.  Only a library built
    in this run has ptxas's report."""
    import ctypes
    import shutil
    from pathlib import Path
    out, smem = {}, {}
    names = [f"flash_attention_packed_w{dp}" for dp in _build.FLASH_WIDTHS]
    for lib_name in names:
        cur = None
        for ln in _build.build_logs.get(lib_name, "").splitlines():
            if "Compiling entry function" in ln:
                cur = k1_kernel_name(ln)
                if cur:
                    out[cur] = {"ptxas": [], "perf_notes": []}
            elif "Potential Performance Loss" in ln:
                name = k1_kernel_name(ln)
                if name in out:
                    out[name]["perf_notes"].append(ln.split("Loss:")[-1].split(
                        " in the function")[0].strip())
            elif cur and ("Used" in ln or "spill" in ln):
                out[cur]["ptxas"].append(ln.split("info    :")[-1].strip())
        lib = ctypes.CDLL(str(libs[lib_name]))
        lib.flash_packed_smem.argtypes = [ctypes.c_int]
        dp = lib_name.rsplit("_w", 1)[1]
        for k, i in K1_SMEM_INDEX.items():
            smem[f"{k}<{dp}>"] = lib.flash_packed_smem(i)
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    hgmma = None
    if Path(cuobjdump).exists():
        hgmma = {}
        for lib_name in names:
            sass = subprocess.run([cuobjdump, "-sass", str(libs[lib_name])],
                                  capture_output=True, text=True,
                                  timeout=300, check=True).stdout
            cur = None
            for ln in sass.splitlines():
                if "Function :" in ln:
                    cur = k1_kernel_name(ln)
                    if cur:
                        hgmma[cur] = 0
                elif cur and "HGMMA" in ln:
                    hgmma[cur] += 1
        short = [k for k, n in hgmma.items() if n == 0]
        if len(hgmma) != 18 or short:
            raise AssertionError(f"K1 kernels without HGMMA (or missing "
                                 f"from the SASS): {hgmma}")
    return {"kernels": out, "dynamic_smem_bytes": smem, "hgmma": hgmma,
            "cuobjdump": cuobjdump if hgmma is not None else None}


K2_TC_KERNEL = re.compile(r"(bhd_(?:fwd|dkdv|dq)_tc)ILi(\d+)E")
K3_SPLIT_KERNEL = re.compile(
    r"(paged_decode_split)I(f|13__nv_bfloat16|6__half)Li(\d+)E")


def ptxas_notes(_build, lib_names, name):
    """Registers, spills and ptxas's performance notes per kernel that
    ``name`` (a mangled name -> short name, or None) picks out of the
    libraries' build logs (only a library built in this run has them)."""
    out = {}
    for lib_name in lib_names:
        cur = None
        for ln in _build.build_logs.get(lib_name, "").splitlines():
            if "Compiling entry function" in ln:
                cur = name(ln)
                if cur:
                    out[cur] = {"ptxas": [], "perf_notes": []}
            elif "Potential Performance Loss" in ln:
                if name(ln) in out:
                    out[name(ln)]["perf_notes"].append(ln.split("Loss:")[-1]
                                                       .split(" in the")[0]
                                                       .strip())
            elif cur and ("Used" in ln or "spill" in ln):
                out[cur]["ptxas"].append(ln.split("info    :")[-1].strip())
    return out


def k2_tc_build(_build, libs):
    """The 3xTF32 forward, dK/dV and dQ kernels' (64/128/256 wide: 9)
    registers, spills, ptxas performance notes and, where cuobjdump is
    found, their count of HGMMA (wgmma) instructions, which must be above
    0 for all 9."""
    import shutil
    from pathlib import Path
    def name(ln):
        m = K2_TC_KERNEL.search(ln)
        return f"{m.group(1)}<{m.group(2)}>" if m else None

    names = [f"flash_attention_w{dp}_f32" for dp in _build.FLASH_WIDTHS]
    out = ptxas_notes(_build, names, name)
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    hgmma = None
    if Path(cuobjdump).exists():
        hgmma = {}
        for lib_name in names:
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
        if len(hgmma) != 9 or not all(hgmma.values()):
            raise AssertionError(f"3xTF32 kernels without HGMMA (or missing "
                                 f"from the SASS): {hgmma}")
    return {"kernels": out, "hgmma": hgmma}


def k3_split_build(_build):
    """The split decode kernel's (f32, bf16, f16; widths up to 1 and 15)
    ptxas notes."""
    def name(ln):
        m = K3_SPLIT_KERNEL.search(ln)
        return (f"{m.group(1)}<{m.group(2).lstrip('0123456789')},"
                f"{m.group(3)}>") if m else None
    return ptxas_notes(_build, ["paged_attention"], name)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
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

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _build.build_all()
    # ptxas's register / spill lines, per library built in this run
    ptxas = {lib: [ln.split("info    :")[-1].strip() for ln in log.splitlines()
                   if "Used" in ln or "spill" in ln]
             for lib, log in _build.build_logs.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library_seconds": _build.build_seconds,
          "libraries": sorted(p.name for p in libs.values()),
          "ptxas": ptxas, "k1": k1_build(_build, libs),
          "k2_3xtf32": k2_tc_build(_build, libs),
          "k3_split_decode": k3_split_build(_build)})

    flash = phase_flash(torch, fap, fa)
    flash_launches = phase_train(torch, fap)
    bhd = phase_flash_bhd(torch, fa, fap, phase_flash_bhd_checks(torch, fa))
    bhd_launches = phase_train_f32(torch, fa, fap)
    phase_wide(torch, fa, fap)
    phase_wide(torch, fa, fap, b=2, gpt=WIDE512_GPT, name="wide512")
    emit({"phase": "wide512_times", **wide512_times(torch, fa, fap, pa)})
    k3_decode, k3_tiles = phase_kernel(torch, pa)
    eng, prompts, launches = phase_serving(torch, pa)
    phase_profile(torch, eng, prompts)
    del eng
    phase_paged_wide(torch, pa)
    max_abs = phase_quant_checks(torch, qm, wo)
    decode = phase_quant(torch, qm, wo)
    k4_launches, arrays, prompts = phase_serving_int8(torch, qm)
    phase_quant_f32_cross_check(torch, arrays, prompts)

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
    kernels.append({"name": "paged_decode_split", "route": "cuda",
                    "source": src + "paged_attention.cu",
                    "replaces": ref + "paged_attention.py:175",
                    "launches": launches["paged_decode"], **k3_decode,
                    "timed_as": "width-1 decode at the serving run's "
                                "geometry (16 slots, 12 heads of 64, pages "
                                "of 16, lengths 64..191), bf16; library: "
                                "SDPA on K/V gathered contiguous"})
    kernels.append({"name": "paged_attention", "route": "cuda",
                    "source": src + "paged_attention.cu",
                    "replaces": ref + "paged_attention.py:175",
                    "launches": launches["paged_attention"], **k3_tiles,
                    "timed_as": "a 32-row prefill chunk at the serving "
                                "run's geometry, bf16 (the tensor-core "
                                "tile kernel); library: SDPA with the "
                                "offset-causal mask on gathered K/V"})
    kernels.append({"name": "quant_matmul", "route": "cuda",
                    "source": src + "quant_matmul.cu",
                    "replaces": ref + "quant_matmul.py:112",
                    "launches": k4_launches, "max_abs_err": max_abs,
                    "ms": decode["ms"], "plain_ms": decode["plain_ms"],
                    "bound_ms": decode["bound_ms"],
                    "bound_by": decode["bound_by"],
                    "library_ms": decode["library_ms"],
                    "timed_as": "one decode layer's 4 projections, M=8, "
                                "int8 (library: the quant phase's)"})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
