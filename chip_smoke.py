#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  -- the card (``nvidia-smi`` name and power limit, torch, CUDA).
2. build   -- compiles every CUDA kernel of the path from ``csrc/`` (nvcc,
              sm_90a), in parallel, and reports the seconds taken.
3. kernel  -- holds ``paged_attention`` against its plain PyTorch version
              (``paged_attention_ref``) at the serving geometry (B=16,
              H=12, D=64, P=16, maxp=32; widths 1 and 32; shuffled page
              tables, an inactive slot, lengths 0 / page boundary / last
              row of the table; and the serving run's own pool, tables
              and lengths): bf16 against an f32 run of the plain version
              at atol=rtol=2e-2, f32 at 2e-5 with TF32 off.  Times the
              kernel, the plain version and
              ``F.scaled_dot_product_attention`` on the gathered
              contiguous K/V (a yardstick the port never calls) at the
              serving run's decode inputs, by CUDA-graph replay over input
              copies larger than the L2.
4. serving -- GPT-2-small (12 layers, hidden 768, 12 heads, vocab 50304) in
              bf16 with Normal(0, 0.02) weights from a numpy seed, through
              ``ServingEngine(cache_mode="paged", max_slots=16, max_len=512,
              page_size=16, num_pages=257, chunk=32, decode_window=32)``:
              16 greedy requests of 64 prompt tokens and 128 new tokens.
              Every request must finish, the kernel's launch count must
              cover every decode step of every layer, and the pool must
              drain.  Then an f32 run of 4 requests x 32 new tokens must be
              token-exact against the dense engine (the plain static-cache
              path), or diverge only at a logit margin <= 1e-3.
5. profile -- device time by kernel over one short serving run
              (``torch.profiler``), for the breakdown in PERF.md.

Then the kernel table line, the ``nvidia-smi`` line, and last the result
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the result line; without a CUDA device it exits 2.
"""

import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12        # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12          # dense tensor-core bf16
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


def kernel_case(torch, dtype, width, seed):
    """Inputs at the serving geometry: shuffled tables, slot 5 inactive
    (all-NULL table, stale length), lengths at 0, page boundaries and the
    last row of the table."""
    B, H, D, P, maxp = 16, 12, 64, 16, 32
    N = 1 + B * maxp
    rng = np.random.RandomState(seed)
    pt = (rng.permutation(N - 1) + 1).reshape(B, maxp).astype(np.int32)
    T = maxp * P
    lengths = rng.randint(0, T - width + 1, B).astype(np.int32)
    lengths[:5] = [0, P, P - 1, 2 * P - 1, T - width]   # T-width: last row
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


def phase_kernel(torch, pa):
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = []

    def check(name, case, tol):
        out = pa.paged_attention_kernel(**case)
        torch.cuda.synchronize()
        ref32 = pa.paged_attention_ref(
            case["q"].float(), case["k_pool"].float(),
            case["v_pool"].float(), case["page_table"], case["lengths"])
        err = (out.float() - ref32).abs()
        ok = bool((err <= tol + tol * ref32.abs()).all())
        rec = {"case": name, "max_abs_err": float(err.max()), "tol": tol,
               "ok": ok}
        checks.append(rec)
        if not ok or not torch.isfinite(out).all():
            raise AssertionError(f"paged_attention kernel disagrees with "
                                 f"its plain version: {rec}")
        return rec["max_abs_err"]

    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-5)):
        for width in (1, 32):
            check(f"{str(dtype).split('.')[-1]}_w{width}_maxlen",
                  kernel_case(torch, dtype, width, seed=width), tol)
    case = serving_case(torch, 1, seed=1)
    err = check("bfloat16_w1_serving", case, 2e-2)
    wide = serving_case(torch, 32, seed=32)
    check("bfloat16_w32_serving", wide, 2e-2)
    maxlen = kernel_case(torch, torch.bfloat16, 1, seed=1)
    cases = copies(case)
    k_ms = device_ms(torch, [lambda c=c: pa.paged_attention_kernel(**c)
                             for c in cases])
    p_ms = device_ms(torch, [lambda c=c: pa.paged_attention_ref(**c)
                             for c in cases])
    # the library yardstick: SDPA on K/V already gathered contiguous
    B, s, H, D = case["q"].shape
    P = case["k_pool"].shape[1]

    def gathered(c):
        rows = (c["page_table"].long()[:, :, None] * P
                + torch.arange(P, device=DEV)).reshape(B, -1)
        kb = c["k_pool"].reshape(-1, H, D)[rows].transpose(1, 2).contiguous()
        vb = c["v_pool"].reshape(-1, H, D)[rows].transpose(1, 2).contiguous()
        qh = c["q"].transpose(1, 2).contiguous()
        qpos = c["lengths"].long()[:, None] + torch.arange(s, device=DEV)
        mask = (torch.arange(rows.shape[1], device=DEV)[None, None]
                <= qpos[..., None])[:, None]
        return qh, kb, vb, mask

    libs = [gathered(c) for c in cases]
    lib = lambda a: F.scaled_dot_product_attention(  # noqa: E731
        a[0], a[1], a[2], attn_mask=a[3])
    lib_err = float((lib(libs[0]).transpose(1, 2).float()
                     - pa.paged_attention_kernel(**case).float()).abs().max())
    l_ms = device_ms(torch, [lambda a=a: lib(a) for a in libs])
    del libs
    b_ms, b_by = bound(case, 2, H100_BF16_FLOPS)
    wide_ms = device_ms(torch, [lambda c=c: pa.paged_attention_kernel(**c)
                                for c in copies(wide)])
    wide_bound, wide_by = bound(wide, 2, H100_BF16_FLOPS)
    maxlen_ms = device_ms(torch, [lambda c=c: pa.paged_attention_kernel(**c)
                                  for c in copies(maxlen)])
    maxlen_bound, maxlen_by = bound(maxlen, 2, H100_BF16_FLOPS)
    emit({"phase": "kernel", "checks": checks,
          "decode_w1_serving": {"ms": k_ms, "plain_ms": p_ms,
                                "library_ms": l_ms,
                                "library_vs_kernel_max_abs": lib_err,
                                "bound_ms": b_ms, "bound_by": b_by},
          "chunk_w32_serving": {"ms": wide_ms, "bound_ms": wide_bound,
                                "bound_by": wide_by},
          "decode_w1_maxlen": {"ms": maxlen_ms, "bound_ms": maxlen_bound,
                               "bound_by": maxlen_by}})
    return {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms}


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
    for _ in range(3):   # host-bound: repeat to show the spread
        ticks0 = dict(eng.stats)
        pa.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reqs = [eng.submit(p, 128) for p in prompts]
        eng.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = pa.launches
        decode_ticks = eng.stats["decode_ticks"] - ticks0["decode_ticks"]
        chunk_ticks = eng.stats["chunk_ticks"] - ticks0["chunk_ticks"]
        for r in reqs:
            toks = np.asarray(r.tokens)
            assert r.done and len(toks) == 128, (r.done, len(toks))
            assert ((toks >= 0) & (toks < cfg.vocab_size)).all()
        # every decode step and every chunk tick runs the kernel once per
        # layer
        need = decode_ticks * eng._decode_window * cfg.num_layers
        assert decode_ticks > 0 and launches >= need, (launches, need)
        assert launches == need + chunk_ticks * cfg.num_layers, launches
        eng.drop_prefix_cache()
        assert eng.kv_pages_in_use == 0, eng.kv_pages_in_use
        ttft = sorted(r.ttft_s for r in reqs)
        runs.append({"wall_s": wall, "tokens_per_s": 16 * 128 / wall,
                     "ttft_p50_s": ttft[len(ttft) // 2],
                     "ttft_max_s": ttft[-1], "decode_ticks": decode_ticks,
                     "chunk_ticks": chunk_ticks, "kernel_launches": launches})
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

    def dev_us(e):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            v = getattr(e, attr, None)
            if v:
                return float(v)
        return 0.0
    # device-side events only (kernels, copies): a CPU op's self device
    # time repeats the time of the kernels it launched
    events = prof.key_averages()
    rows = [(e.key, dev_us(e), e.count) for e in events
            if str(getattr(e, "device_type", "")).endswith("CUDA")]
    rows = [r for r in rows if r[1] > 0]
    total = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    host = sorted(((e.key, float(e.self_cpu_time_total), e.count)
                   for e in events
                   if str(getattr(e, "device_type", "")).endswith("CPU")),
                  key=lambda r: -r[1])
    emit({"phase": "profile", "requests": 16, "new_tokens": 32,
          "wall_s": wall,
          "device_busy_s": total / 1e6 if total else None,
          "device_idle_share": (1 - total / 1e6 / wall) if total else None,
          "top_kernels": [{"name": k[:80], "device_ms": us / 1e3,
                           "count": n} for k, us, n in rows[:12]],
          "top_host_ops": [{"name": k[:60], "self_cpu_ms": us / 1e3,
                            "count": n} for k, us, n in host[:12]]})


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import _build
    from paddle_hackathon_tpu_torch.incubate.nn.kernels import \
        paged_attention as pa

    smi = nvidia_smi()
    name = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": name,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    libs = _build.build_all()
    ptxas = [ln.strip() for log in _build.build_logs.values()
             for ln in log.splitlines() if "Used" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(p.name for p in libs.values()),
          "ptxas": ptxas[:12]})

    kern = phase_kernel(torch, pa)
    eng, prompts, launches = phase_serving(torch, pa)
    phase_profile(torch, eng, prompts)

    emit({"kernels": [{
        "name": "paged_attention", "route": "cuda",
        "source": "paddle_hackathon_tpu_torch/csrc/paged_attention.cu",
        "replaces": "paddle_hackathon_tpu/incubate/nn/kernels/"
                    "paged_attention.py:114",
        "launches": launches, **kern}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
