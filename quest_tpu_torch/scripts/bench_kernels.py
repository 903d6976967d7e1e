"""Kernel-level benchmark of the decode pipeline's stages (counterpart of
``scripts/bench_kernels.py``, the NVBench analogue).

Each stage runs at the JAX script's shapes and is reported with the same
bytes-moved (or FLOP) accounting, so its rate can be set against the
card's peak (3.35 TB/s HBM, 989 TFLOP/s dense bf16 on the H100). On the
card every stage is timed by ``utils/benchmarking.py:Timer`` (CUDA
events, L2 flushed between launches; ``--iters`` timed launches after
three untimed ones); with ``--device cpu`` the plain versions are timed by the
host clock.

Stages: ``estimate`` (``page_scores_physical``, the decode step's
estimate over the physical metadata through the block table: the
physical route of ``csrc/estimate.cu`` on the card), ``topk``
(``select_pages``: ``csrc/topk_select.cu`` on the card), ``sparse``
(the sparse decode kernel over the selected pages), ``dense`` (the
dense decode kernel over the context), ``append`` (``append_decode_at``
at a fixed position: ``csrc/append.cu`` on the card), ``prefill`` (a
2048-token chunk at the end of the context) and ``pipeline`` (estimate
-> top-k -> sparse). The JSON line holds each stage's microseconds under
the JAX script's names. The port's own stages, which the JAX script does
not have, run when named: ``rope`` (``rotate_qk`` of a decode step's bf16
q and k, one token a row: ``csrc/rope.cu`` on the card),
``rope_prefill`` (the same over a chunk of up to 8192 tokens),
``rope_append`` (the decode step's rope and append in one op,
``rope_append_decode_at`` on bf16 q, k and v: ``csrc/append.cu`` with its
rotate flag on the card),
``rms_norm`` (a decode step's norm with its residual add, bf16 rows of
the model width heads x head_dim: ``csrc/rms_norm.cu`` on the card),
``rms_norm_prefill`` (the same over a chunk of up to 8192 tokens),
``head_gemv`` (the decode step's f32 product with a bf16 head of
``--vocab`` columns: ``csrc/head_gemv.cu`` on the card),
``append_prefill`` (``append_prefill_at`` of a bf16 chunk of up to 8192
tokens a row into a pool of its own, from position 0, the rows'
lengths ``--prefill-lens``: ``csrc/append.cu``'s prefill route on the
card), ``silu_mul`` (the MLP's SiLU product of a decode step's bf16 rows
of ``--inter`` columns: ``csrc/silu_mul.cu`` on the card) and
``silu_mul_prefill`` (the same over a chunk of up to 8192 tokens).

    python -m quest_tpu_torch.scripts.bench_kernels [--ctx 32768]
        [--budget 2048] [--heads 32] [--kv-heads 32] [--stages all|...]
    python -m quest_tpu_torch.scripts.bench_kernels --stages \\
        append,rope,rope_prefill,rope_append --kv-heads 8   # rope and append
    python -m quest_tpu_torch.scripts.bench_kernels --stages \\
        rms_norm,rms_norm_prefill,head_gemv --batch 2    # norm and head
    python -m quest_tpu_torch.scripts.bench_kernels --stages \\
        append_prefill,silu_mul,silu_mul_prefill --kv-heads 8 --ctx 8192
    python -m quest_tpu_torch.scripts.bench_kernels --stages append_prefill \\
        --kv-heads 8 --ctx 5120 --batch 2 --prefill-lens 5000,2500
    python -m quest_tpu_torch.scripts.bench_kernels --device cpu \\
        --ctx 2048 --budget 256 --heads 4 --kv-heads 2          # smoke
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time

import torch

WARMUP = 3                       # untimed calls before a stage's timed ones
STAGES = ("estimate", "topk", "sparse", "dense", "append", "prefill",
          "pipeline")
# Stage -> the JSON key of the JAX script.
RESULT_KEYS = {"estimate": "estimate", "topk": "topk",
               "sparse": "sparse_attn", "dense": "dense_attn",
               "append": "append_decode", "prefill": "prefill",
               "pipeline": "sparse_pipeline"}
# The port's own stages (not in "all": the JAX script has none), by key.
PORT_STAGES = {"rope": "rope_decode", "rope_prefill": "rope_prefill",
               "rope_append": "rope_append_decode",
               "rms_norm": "rms_norm_decode",
               "rms_norm_prefill": "rms_norm_prefill",
               "head_gemv": "head_gemv", "append_prefill": "append_prefill",
               "silu_mul": "silu_mul_decode",
               "silu_mul_prefill": "silu_mul_prefill"}
ROPE_CHUNK = 8192                # rope_prefill's tokens (at most ctx)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=32768)
    ap.add_argument("--budget", type=int, default=2048)
    ap.add_argument("--page", type=int, default=16)
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--kv-heads", type=int, default=32)
    ap.add_argument("--head-dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=128256,
                    help="the head_gemv stage's columns")
    ap.add_argument("--inter", type=int, default=14336,
                    help="the silu_mul stages' columns (the MLP's width)")
    ap.add_argument("--prefill-lens", type=str, default=None,
                    help="the append_prefill stage's new tokens a row, "
                         "comma-separated (default: the chunk each)")
    ap.add_argument("--stages", type=str, default="all")
    ap.add_argument("--iters", type=int, default=20,
                    help="timed launches a stage (the median is reported), "
                         f"after {WARMUP} untimed")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def stage_bytes(B, Hkv, D, page, ctx, budget_pages, max_pages,
                bpe=2) -> dict:
    """Bytes each stage must move, the JAX script's accounting (bf16)."""
    meta = 2 * B * Hkv * max_pages * D * bpe
    pages = 2 * B * Hkv * budget_pages * page * D * bpe
    return {"estimate": meta, "topk": B * Hkv * max_pages * 4,
            "sparse": pages, "dense": 2 * B * Hkv * ctx * D * bpe,
            "append": 2 * B * Hkv * (page + 2) * D * bpe,
            "pipeline": meta + pages}


def rope_bytes(B, T, Hq, Hkv, D, bpe=2) -> int:
    """q and k read and written once, cos and sin (f32) read once."""
    return 2 * B * T * (Hq + Hkv) * D * bpe + 2 * B * T * (D // 2) * 4


def rope_append_bytes(B, Hq, Hkv, D, bpe=2) -> int:
    """q read and written, k and v read and written into a pool of their
    dtype, the metadata rows read and written, cos and sin (f32), the
    lengths and table entries read."""
    return (2 * B * Hq * D * bpe + 4 * B * Hkv * D * bpe
            + 4 * B * Hkv * D * bpe + 2 * B * (D // 2) * 4 + 8 * B)


def norm_bytes(rows, hid, bpe=2) -> int:
    """x and the residual read, h and the norm written, the weight read
    once."""
    return 4 * rows * hid * bpe + hid * bpe


def head_bytes(B, hid, vocab) -> int:
    """The bf16 head read once, f32 x read and the f32 logits written."""
    return hid * vocab * 2 + B * (hid + vocab) * 4


def append_prefill_bytes(offsets, lens, T, Hkv, D, page, P, in_bpe=2,
                         kv_bpe=2, meta_bpe=2) -> int:
    """What one prefill append of ``T`` tokens a row must move, rows at
    ``offsets`` with ``lens`` new tokens, into a pool of ``P`` pages a
    row: for each non-empty row k and v read and their T rows written,
    the old pool keys of its window's valid slots that the chunk does not
    write read, the metadata rows of window pages with a valid slot
    written, and the W = min(P, T // page + 2) table entries read; every
    row's length and new length read."""
    W = min(P, T // page + 2)
    total = 0
    for off, n in zip(offsets, lens):
        total += 8
        if n <= 0:
            continue
        p0 = min(off // page, P - W)
        start = p0 * page + min(max(off - p0 * page, 0), W * page - T)
        end = min(off + n, (p0 + W) * page)   # the window's valid slots
        old = max(0, min(start, end) - p0 * page) + max(0, end - start - T)
        pages = max(0, -(-(end - p0 * page) // page))
        total += (2 * T * Hkv * D * (in_bpe + kv_bpe) + old * Hkv * D * kv_bpe
                  + 2 * pages * Hkv * D * meta_bpe + 4 * W)
    return total


def silu_mul_bytes(rows, inter, bpe=2) -> int:
    """gate and up read, the product written."""
    return 3 * rows * inter * bpe


def prefill_flops(B, Hq, D, ctx, chunk) -> float:
    """Two matmuls x 2 FLOPs a MAC x chunk x the mean causal span x D, a
    head: a chunk at the end of the context attends to all of it."""
    return 2 * 2 * B * Hq * chunk * (ctx - chunk / 2) * D


class HostTimer:
    """Median host-clock ms of ``fn`` (the plain versions on the CPU)."""

    def __call__(self, fn, iters, warmup):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            t = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t) * 1e3)
        return statistics.median(times)


def stage_kernels():
    """Stage -> the kernel wrapper it launches (None: plain PyTorch ops)."""
    from quest_tpu_torch.kv.paged_kv import (append_decode_at,
                                             append_prefill_at,
                                             rope_append_decode_at)
    from quest_tpu_torch.ops.dense_decode import dense_decode_attention
    from quest_tpu_torch.ops.estimate import page_scores_physical
    from quest_tpu_torch.ops.fused_decode import exact_topk_select
    from quest_tpu_torch.ops.head_gemv import head_gemv
    from quest_tpu_torch.ops.prefill import prefill_attention
    from quest_tpu_torch.ops.rms_norm import rms_norm
    from quest_tpu_torch.ops.rope import rotate_qk
    from quest_tpu_torch.ops.silu_mul import silu_mul
    from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
    return {"estimate": page_scores_physical, "topk": exact_topk_select,
            "sparse": sparse_decode_attention,
            "dense": dense_decode_attention, "append": append_decode_at,
            "prefill": prefill_attention, "pipeline": sparse_decode_attention,
            "rope": rotate_qk, "rope_prefill": rotate_qk,
            "rope_append": rope_append_decode_at, "rms_norm": rms_norm,
            "rms_norm_prefill": rms_norm, "head_gemv": head_gemv,
            "append_prefill": append_prefill_at, "silu_mul": silu_mul,
            "silu_mul_prefill": silu_mul}


def run_bench_kernels(args, detail=None) -> dict:
    """Runs the stages of ``args`` (see :func:`parse_args`); returns
    {JAX stage name: us}. ``detail``, if a dict, receives each stage's
    bytes or FLOPs, rate, kernel launches and timed calls."""
    from quest_tpu_torch.config import ModelConfig, QuestConfig, RopeConfig
    from quest_tpu_torch.kv.paged_kv import (append_decode_at,
                                             append_prefill_at, init_cache,
                                             rope_append_decode_at)
    from quest_tpu_torch.ops.dense_decode import dense_decode_attention
    from quest_tpu_torch.ops.estimate import page_scores_physical
    from quest_tpu_torch.ops.head_gemv import head_gemv
    from quest_tpu_torch.ops.prefill import prefill_attention
    from quest_tpu_torch.ops.rms_norm import rms_norm
    from quest_tpu_torch.ops.rope import (compute_rope_params, rope_cos_sin,
                                          rotate_qk)
    from quest_tpu_torch.ops.silu_mul import silu_mul
    from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
    from quest_tpu_torch.ops.topk import select_pages
    from quest_tpu_torch.ops.utils import resolve_device

    asked = set(args.stages.split(","))
    known = STAGES + tuple(PORT_STAGES)
    if asked - set(known) - {"all"}:
        raise SystemExit(f"unknown stages {sorted(asked - set(known))}; "
                         f"known: {known}")
    want = STAGES if "all" in asked else [s for s in known if s in asked]
    dev = resolve_device(args.device)
    B, Hq, Hkv, D = args.batch, args.heads, args.kv_heads, args.head_dim
    page, CTX, BUDGET = args.page, args.ctx, args.budget
    model = ModelConfig(num_heads=Hq, num_kv_heads=Hkv, head_dim=D)
    quest = QuestConfig(page_size=page, token_budget=BUDGET, max_seq_len=CTX)
    S, P = quest.page_budget, quest.max_pages
    sm = 1.0 / math.sqrt(D)
    log(f"device={dev} B={B} Hq={Hq} Hkv={Hkv} D={D} ctx={CTX} pages={P} "
        f"budget={BUDGET} ({S} page slots)")

    gen = torch.Generator(device=dev).manual_seed(0)
    cache = init_cache(model, quest, batch_size=B, num_layers=1, device=dev)
    kw = dict(layer=0, block_tab=cache.block_tab,
              block_pages=cache.block_pages)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev) * 0.3

    append_prefill_at(cache, 0, normal(B, CTX, Hkv, D), normal(B, CTX, Hkv, D))
    cache.seq_lens.fill_(CTX)
    seq = cache.seq_lens.clone()
    q0 = normal(B, Hq, D)

    def estimate():
        return page_scores_physical(q0, cache.k_max[0], cache.k_min[0],
                                    cache.block_tab)

    scores0 = estimate()
    idx0, nv0 = select_pages(scores0, seq, page, S)

    nbytes = stage_bytes(B, Hkv, D, page, CTX, S, P)
    CHUNK = min(2048, CTX)
    qp = normal(B, CHUNK, Hq, D)
    offs = torch.full((B,), CTX - CHUNK, dtype=torch.int32, device=dev)
    kv1 = q0[:, :Hkv, :].contiguous()

    def pipeline():
        idx, nv = select_pages(estimate(), seq, page, S)
        return sparse_decode_attention(q0, cache.kv_pages, idx, nv, seq,
                                       sm_scale=sm, **kw)

    def rope_args(T):
        """bf16 q [B, T, Hq, D] and k [B, T, Hkv, D] at the context's end,
        and their (cos, sin)."""
        inv, ps, att = compute_rope_params(RopeConfig(), D)
        pos = (seq[:, None] - T + torch.arange(T, device=dev)).int()
        return (normal(B, T, Hq, D).bfloat16(),
                normal(B, T, Hkv, D).bfloat16(),
                *rope_cos_sin(pos, inv, ps, att))

    RT = min(ROPE_CHUNK, CTX)
    rope_in = {n: rope_args(t) for n, t in (("rope", 1), ("rope_prefill", RT))
               if n in want}
    nbytes.update(rope=rope_bytes(B, 1, Hq, Hkv, D),
                  rope_prefill=rope_bytes(B, RT, Hq, Hkv, D),
                  rope_append=rope_append_bytes(B, Hq, Hkv, D))
    if "rope_append" in want:
        q1, k1, c1, s1 = rope_args(1)
        ra_in = (q1[:, 0].contiguous(), k1[:, 0].contiguous(),
                 k1[:, 0].clone(), c1, s1)

    HID, V = Hq * D, args.vocab

    def norm_args(T):
        """bf16 x and residual [B, T, heads x head_dim], weight, eps."""
        return (normal(B, T, HID).bfloat16(), 1 + normal(HID).bfloat16(),
                1e-5, normal(B, T, HID).bfloat16())

    norm_in = {n: norm_args(t) for n, t in (("rms_norm", 1),
                                            ("rms_norm_prefill", RT))
               if n in want}
    head_in = ((normal(B, HID), (normal(HID, V) / math.sqrt(HID)).bfloat16())
               if "head_gemv" in want else None)
    nbytes.update(rms_norm=norm_bytes(B, HID),
                  rms_norm_prefill=norm_bytes(B * RT, HID),
                  head_gemv=head_bytes(B, HID, V))

    # The prefill append: a chunk of RT tokens a row from position 0 of a
    # pool of its own (the other stages' pool keeps its context).
    lens = ([int(x) for x in args.prefill_lens.split(",")]
            if args.prefill_lens else [RT] * B)
    if len(lens) != B:
        raise SystemExit(f"--prefill-lens gives {len(lens)} rows, --batch "
                         f"{B}")
    if "append_prefill" in want:
        pcache = init_cache(model, quest, batch_size=B, num_layers=1,
                            device=dev)
        p_in = (normal(B, RT, Hkv, D).bfloat16(),
                normal(B, RT, Hkv, D).bfloat16(),
                torch.tensor(lens, dtype=torch.int32, device=dev))
    silu_in = {n: (normal(B, t, args.inter).bfloat16(),
                   normal(B, t, args.inter).bfloat16())
               for n, t in (("silu_mul", 1), ("silu_mul_prefill", RT))
               if n in want}
    nbytes.update(append_prefill=append_prefill_bytes([0] * B, lens, RT, Hkv,
                                                        D, page, P),
                  silu_mul=silu_mul_bytes(B, args.inter),
                  silu_mul_prefill=silu_mul_bytes(B * RT, args.inter))

    fns = {
        "estimate": estimate,
        "topk": lambda: select_pages(scores0, seq, page, S),
        "sparse": lambda: sparse_decode_attention(
            q0, cache.kv_pages, idx0, nv0, seq, sm_scale=sm, **kw),
        "dense": lambda: dense_decode_attention(
            q0, cache.kv_pages, seq, sm_scale=sm, **kw),
        # seq_lens is not advanced: every call writes the same position.
        "append": lambda: append_decode_at(cache, 0, kv1, kv1),
        "prefill": lambda: prefill_attention(qp, cache.kv_pages, offs, seq,
                                             sm_scale=sm, **kw),
        "pipeline": pipeline,
        "rope": lambda: rotate_qk(*rope_in["rope"]),
        "rope_prefill": lambda: rotate_qk(*rope_in["rope_prefill"]),
        # seq_lens is not advanced: every call writes the same position.
        "rope_append": lambda: rope_append_decode_at(cache, 0, *ra_in),
        "rms_norm": lambda: rms_norm(*norm_in["rms_norm"]),
        "rms_norm_prefill": lambda: rms_norm(*norm_in["rms_norm_prefill"]),
        "head_gemv": lambda: head_gemv(*head_in),
        # seq_lens stays 0: every call writes the same chunk.
        "append_prefill": lambda: append_prefill_at(pcache, 0, *p_in),
        "silu_mul": lambda: silu_mul(*silu_in["silu_mul"]),
        "silu_mul_prefill": lambda: silu_mul(*silu_in["silu_mul_prefill"]),
    }
    if dev.type == "cuda":
        from quest_tpu_torch.utils.benchmarking import Timer
        timer = Timer()
    else:
        timer = HostTimer()
    kernels = stage_kernels()
    keys = {**RESULT_KEYS, **PORT_STAGES}
    results = {}
    for name in want:
        kernel = kernels[name]
        if kernel is not None:
            kernel.launches = 0
        ms = timer(fns[name], iters=args.iters, warmup=WARMUP)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t = ms * 1e-3
        row = dict(us=ms * 1e3, calls=args.iters + WARMUP,
                   launches=kernel.launches if kernel is not None else 0,
                   kernel=kernel.__name__ if kernel is not None else None)
        if name == "prefill":
            flops = prefill_flops(B, Hq, D, CTX, CHUNK)
            row.update(flops=flops, tflops=flops / t / 1e12)
            log(f"{'prefill':16s} {t * 1e6:9.1f} us   {flops / t / 1e12:7.1f} "
                f"TFLOP/s (chunk {CHUNK} @ end of {CTX})")
        else:
            row.update(bytes=nbytes[name], gbps=nbytes[name] / t / 1e9)
            log(f"{keys[name]:16s} {t * 1e6:9.1f} us   "
                f"{nbytes[name] / t / 1e9:7.1f} GB/s "
                f"({nbytes[name] / 1e6:.1f} MB)")
        results[keys[name]] = round(ms * 1e3, 1)
        if detail is not None:
            detail[keys[name]] = row
    return results


def main(argv=None):
    args = parse_args(argv)
    out = run_bench_kernels(args)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
