"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then not 0):
  1. the card's name and power limit; the flash kernel's build from
     ray_tpu_torch/csrc/flash_fwd.cu and what ptxas reported;
  2. the kernel against its plain PyTorch version on the same bf16 inputs
     at the serving shapes, with its time, the plain version's, that of
     torch's scaled_dot_product_attention (a yardstick only; the port never
     calls it) and the least time the card could take;
  3. a small fp32 model on the card: logits through the kernel against the
     plain path on the CPU, and engine tokens against generate_greedy;
  4. the main path at Llama-3-8B full width and depth with random weights:
     forward over [1, 1024] tokens, then an LLMServer answering six
     concurrent requests (one streamed) that hit every prefill bucket.
     The kernel's launch count is reset just before and read just after,
     and must equal n_layers x (forwards + prefills);
  5. where the time goes: the warm forward time and a torch.profiler
     window over decode steps with every slot busy.
The last three lines are a JSON object describing each kernel, the
card's name and power limit again, and the device record.
"""

from __future__ import annotations

import asyncio
import json
import math
import subprocess
import sys
import time

import torch

H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak
# bf16 outputs are held per element to |got - want| <= ATOL + RTOL * |want|:
# both sides round to bf16 once after fp32 sums taken in different orders,
# so they may differ by a rounding step, which is under 2**-7 = 7.8e-3 of
# the value; RTOL allows two, and ATOL covers outputs near zero.
BF16_ATOL = 4e-3
BF16_RTOL = 1.6e-2
FP32_TOL = 1e-4


def log(*parts):
    print(*parts, flush=True)


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(B, L, H, Hkv, D, causal, itemsize=2):
    """Least time for the attention: q, k, v read once and o written once
    at the card's memory rate, against the products this mask needs at
    its bf16 peak; the larger one bounds."""
    nbytes = itemsize * (2 * B * L * H * D + 2 * B * L * Hkv * D)
    pairs = L * (L + 1) // 2 if causal else L * L
    flops = 4 * B * H * D * pairs
    t_bytes, t_ops = nbytes / H100_BYTES_PER_S, flops / H100_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout
    return out.strip().splitlines()[0]


def check_kernel(attention, gen):
    """Kernel vs plain version at the serving shapes; returns the rows."""
    import torch.nn.functional as F

    shapes = [  # (B, L, H, Hkv, D, causal)
        (1, 16, 32, 8, 128, True), (1, 64, 32, 8, 128, True),
        (1, 256, 32, 8, 128, True), (1, 1024, 32, 8, 128, True),
        (1, 200, 32, 8, 128, True), (1, 256, 32, 8, 64, True),
        (1, 256, 32, 8, 128, False), (2, 256, 32, 8, 128, True),
    ]
    rows = []
    for B, L, H, Hkv, D, causal in shapes:
        q = torch.randn(B, L, H, D, generator=gen, device="cuda").bfloat16()
        k = torch.randn(B, L, Hkv, D, generator=gen, device="cuda").bfloat16()
        v = torch.randn(B, L, Hkv, D, generator=gen, device="cuda").bfloat16()
        got = attention.flash_attention(q, k, v, causal=causal)
        want = attention.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        # worst share of the per-element limit; above 1 fails
        worst = float((diff / (BF16_ATOL + BF16_RTOL * want.float().abs()))
                      .max())
        if not worst <= 1.0:
            raise AssertionError(f"flash kernel disagrees at B={B} L={L} "
                                 f"D={D} causal={causal}: max_abs_err "
                                 f"{err}, {worst} of the limit")
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        ms = time_ms(lambda: attention.flash_attention(q, k, v, causal),
                     20)
        plain_ms = time_ms(
            lambda: attention.flash_attention_plain(q, k, v, causal), 3)
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
        bound_ms, bound_by = attention_bound(B, L, H, Hkv, D, causal)
        row = dict(B=B, L=L, H=H, Hkv=Hkv, D=D, causal=causal,
                   max_abs_err=err, share_of_limit=worst, atol=BF16_ATOL,
                   rtol=BF16_RTOL, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound_ms, bound_by=bound_by)
        rows.append(row)
        log("kernel_check", json.dumps(row))
    # fp32 inputs take the same kernel in its fp32 instantiation.
    q, k, v = (torch.randn(1, 200, 4, 64, generator=gen, device="cuda")
               for _ in range(3))
    err = float((attention.flash_attention(q, k[:, :, :2], v[:, :, :2], True)
                 - attention.flash_attention_plain(q, k[:, :, :2],
                                                   v[:, :, :2], True))
                .abs().max())
    if not err <= FP32_TOL:
        raise AssertionError(f"fp32 flash kernel disagrees: {err}")
    log(f"kernel_check fp32 L=200 D=64 GQA: max_abs_err={err} "
        f"tol={FP32_TOL}")
    return rows


def check_small_model(models, gen):
    """fp32 on the card against the plain path on the CPU."""
    cfg = models.LlamaConfig(vocab_size=512, d_model=256, n_layers=2,
                             n_heads=4, n_kv_heads=2, d_ff=512,
                             dtype=torch.float32)
    params = models.init_params(cfg, gen, device="cuda")
    cpu_params = {k: (v.cpu() if torch.is_tensor(v) else
                      [{n: t.cpu() for n, t in lay.items()} for lay in v])
                  for k, v in params.items()}
    tokens = torch.randint(0, 512, (2, 100), generator=gen, device="cuda")
    got = models.forward(params, tokens, cfg)
    want = models.forward(cpu_params, tokens.cpu(), cfg)
    err = float((got.cpu() - want).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"small model logits differ from the CPU "
                             f"path by {err}")
    prompts = {"a": [1, 2, 3, 4], "b": list(range(10, 30)), "c": [7] * 70}
    eng = models.GenerationEngine(params, cfg, max_slots=2, max_len=128)
    for rid, p in prompts.items():
        eng.submit(rid, p, max_new_tokens=10)
    out = eng.run_to_completion()
    for rid, p in prompts.items():
        ref = models.generate_greedy(params, torch.tensor([p], device="cuda"),
                                     cfg, max_new=10)[0].tolist()
        if out[rid] != ref:
            raise AssertionError(f"engine tokens {out[rid]} != greedy {ref}")
    log(f"small_model fp32: logits max_abs_err vs CPU plain path={err} "
        f"(tol 1e-3); engine tokens == generate_greedy for "
        f"{len(prompts)} prompts")


def where_time_goes(models, params, cfg, server, tokens):
    """After the main path: the warm forward time, and a profile of decode
    steps with every slot busy (kernel time by name, device busy share)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fwd_ms = time_ms(lambda: models.forward(params, tokens, cfg), 3)
    log(f"forward LLAMA3_8B [1, 1024] warm: {fwd_ms} ms per call")
    eng = server.engine
    gen = torch.Generator().manual_seed(2)
    for i in range(eng.S):
        eng.submit(f"profile{i}", torch.randint(
            0, cfg.vocab_size, (200,), generator=gen).tolist(),
            max_new_tokens=48)
    for _ in range(4):  # the admitting step (4 prefills), then warm steps
        eng.step()
    torch.cuda.synchronize()
    steps, profiled = 16, 8
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(profiled):
            eng.step()
        torch.cuda.synchronize()
    kernels = sorted(((e.self_device_time_total, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     reverse=True)
    busy_s = sum(t for t, _, _ in kernels) / 1e6 / profiled
    log(f"decode: {eng.S} slots at ~200 tokens of context: "
        f"{step_s * 1e3} ms/step over {steps} steps = {eng.S / step_s} "
        f"tokens/s; over {profiled} profiled steps the device ran "
        f"{busy_s * 1e3} ms/step, {busy_s / step_s} of the unprofiled step,"
        f" in {sum(n for _, n, _ in kernels) / profiled} kernels/step")
    for t, n, name in kernels[:10]:
        log(f"  {t / profiled / 1e3} ms/step in {n / profiled} calls: "
            f"{name[:100]}")
    eng.run_to_completion()


async def serve_requests(server, requests):
    async def one(body):
        if body.get("stream"):
            return [t async for t in await server(body)]
        return (await server(body))["tokens"]

    return await asyncio.gather(*[one(b) for b in requests])


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from ray_tpu_torch import models
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.serve import LLMServer
    from ray_tpu_torch.util import events

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}"
        f"; devices {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = attention.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0} s")
    ptxas = lib.with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas:", line.strip())

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = check_kernel(attention, gen)
    check_small_model(models, gen)

    cfg = models.LLAMA3_8B
    t0 = time.perf_counter()
    params = models.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    log(f"init LLAMA3_8B: {cfg.param_count()} params in "
        f"{time.perf_counter() - t0} s, "
        f"{torch.cuda.memory_allocated() / 2**30} GiB allocated")
    tokens = torch.randint(0, cfg.vocab_size, (1, 1024), generator=gen,
                           device="cuda")
    prompt_gen = torch.Generator().manual_seed(1)
    plens, news = [5, 40, 200, 600, 12, 100], [32, 24, 16, 16, 32, 20]
    requests = [{"prompt": torch.randint(0, cfg.vocab_size, (n,),
                                         generator=prompt_gen).tolist(),
                 "max_new_tokens": m} for n, m in zip(plens, news)]
    requests[4]["stream"] = True
    server = LLMServer(lambda: (params, cfg), max_slots=4, max_len=1024)

    # ---- the main path: counts reset just before, read just after
    attention.launches = 0
    events.reset()
    t0 = time.perf_counter()
    logits = models.forward(params, tokens, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    finite = bool(torch.isfinite(logits).all())
    t0 = time.perf_counter()
    outs = asyncio.run(serve_requests(server, requests))
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = attention.launches
    # ---- end of the main path

    if logits.shape != (1, 1024, cfg.vocab_size) or not finite:
        raise AssertionError(f"forward logits {tuple(logits.shape)}, "
                             f"finite={finite}")
    log(f"forward LLAMA3_8B [1, 1024], first call: {fwd_s} s, logits "
        f"finite")
    for body, toks in zip(requests, outs):
        if len(toks) != body["max_new_tokens"] or \
                not all(0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"bad response {toks} for prompt of "
                                 f"{len(body['prompt'])}")
    rows_ev, _ = events.drain()
    ttft = [r[5] for r in rows_ev if r[1] == "serve.req.first_token"]
    n_tok = sum(len(t) for t in outs)
    prefills = server.engine.prefills
    log(f"serve LLAMA3_8B: {len(requests)} requests (prompts {plens}, one "
        f"streamed), {n_tok} tokens in {serve_s} s = "
        f"{n_tok / serve_s} tokens/s; TTFT s = "
        f"{ttft}; prefills {prefills}")
    expected = cfg.n_layers * (1 + prefills)
    if prefills != len(requests) or launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times on "
                             f"the main path, expected {expected}")
    log(f"main path: flash_fwd launches {launches} == {cfg.n_layers} x "
        f"(1 forward + {prefills} prefills)")

    where_time_goes(models, params, cfg, server, tokens)

    main = next(r for r in rows if r["L"] == 1024)
    kernels = [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/attention.py:109",
        "also_replaces": "ray_tpu/ops/attention.py:231 (forward)",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "shape": "B=1 L=1024 H=32 Hkv=8 D=128 causal bf16",
    }]
    if not all(math.isfinite(main[k]) for k in ("ms", "plain_ms",
                                                 "library_ms")):
        raise AssertionError(f"non-finite timing {main}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
