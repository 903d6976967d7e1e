#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (quest_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card: torch's device name and nvidia-smi's name and power limit;
  2. build every CUDA kernel of the port (one nvcc per source, all
     started together);
  3. the unfused decode step's selection first (the estimate's physical
     route within 1e-5 of ``page_scores_physical_plain``, the select's
     ids and num_valid bit for bit those of ``select_pages_plain``, the
     two together with no id flipped outside 1e-5 of the K-th score:
     B=1 over 32768 and 131072 tokens and B=2 rows of 5000+2500 at page
     16, fp8 metadata at page 32, per query head, group sum, groups of 3
     and 1, the 256 fp8 codes, idle rows, K > P, tie rows; timed in
     turns with the plain versions, ``torch.bmm`` and ``torch.topk``, the
     estimate under the memset flush and ``Timer(flush="read")``; the
     estimate's registers and shared memory from ``-Xptxas -v`` and its
     launch plans); then
     each kernel against its plain PyTorch version at the serving
     path's shapes (Llama-3.1-8B attention: 32 query heads, 8 KV heads,
     head dim 128, page 16, bf16, 64-page allocation blocks, a shuffled
     block table, a bf16 query as the serving path gives it; once more
     with an f32 query), timed with CUDA events beside its bound, its
     plain version and one PyTorch library call; prefill also at the
     serving phase's shape (B=2, T=5120, rows of 5000 and 2500 tokens),
     its yardstick SDPA restricted to each of the flash, cuDNN and
     efficient-attention kernels with a bottom-right causal mask (the
     fastest that agrees with the plain version counts; at the serving
     shape one call with the explicit causal-and-length boolean mask);
     The fused path's kernels are held the same way: the streaming
     estimate within 1e-5, the select's ids bit for bit (random rows
     and boundary ties), the fused decode within 2e-2 with every
     selected id that differs from the plain selection inside a 1e-5
     band around the K-th score, timed beside the unfused pipeline, and
     once more over 8-token pages (two pages an attention chunk);
     then the layer's plain-op region on its two kernels, bit for bit
     against their plain versions: the decode append (``csrc/append.cu``)
     at the main path's B=2 shape, over every (pool, metadata) dtype pair
     with scratch, shared-block, first-token and clamped rows, and an fp8
     pool on all 65536 bf16 codes; rope of q and k (``csrc/rope.cu``) at
     decode and prefill shapes in bf16 and f32; the decode step's rope
     and append in one launch (``csrc/append.cu``'s rotate flag) on the
     same append cases with G = 4, 1 and 8, q_rot, pool and metadata bit
     for bit; each timed under the memset and the read flush beside its
     plain version, the merged op also beside rope then append;
     then the two kernels in place of the JAX model's norm and head
     fusions: RMSNorm with its residual add (``csrc/rms_norm.cu``) at
     decode and prefill shapes, bf16 and f32, h bit for bit and the norm
     within note d's bound of ``rms_norm_plain``, and the f32 product
     with the bf16 lm_head (``csrc/head_gemv.cu``) at M = 1, 2, 4 and 16
     over 4096 x 128256, the tp = 2 shard and an odd vocabulary, within
     1e-5 of the f32 product, each timed under both flushes beside its
     plain version and the library call;
     then the prefill's KV append (``csrc/append.cu``'s prefill route)
     bit for bit against its plain version outside scratch block 0 at
     the T=8192 chunk of one row and the serving phase's B=2 chunk, then
     over every (pool, metadata) dtype pair on chunks with empty, short
     and full rows, W = P, a window clamped at the pool's end, e4m3
     codes past 448 and a page whose only valid key is below -3.0e38;
     and the MLP's SiLU product
     (``csrc/silu_mul.cu``) at the decode and T=8192 shapes in bf16 and
     f32, an odd length with inf and NaN and an unaligned view, bit for
     bit or within 1 ulp; each timed under both flushes beside its plain
     version;
     then the fp8 e4m3 branches of the sparse, dense, prefill and
     estimate kernels (fp8 pool and metadata) at page 16 and at page 32,
     each also timed beside its bf16 branch on the same values;
  4. the probe path: the copy probe (exp/gather_ab, exp/dma_probe) over
     256 MB, contig and gather at pages of 8, 16 and 32 KB, against its
     plain version, timed in turns; no reading may pass 3.35 TB/s; the
     seven select pieces (exp/select_compile2) against theirs;
  5. the port's slices end to end against their plain CPU path on a
     small 4-layer model with the sparse path live, unfused and fused:
     in bf16 (the serving path's dtypes) the greedy tokens agree at
     every step; in f32 (f32 model and KV pool) they agree and the
     logits are within 2e-3; then the serving configuration (page 32,
     fp8 metadata) with a bf16 and with an fp8 KV pool, f32 model: the
     greedy tokens agree at every step;
  6. the full-width Llama-3.1-8B (32 layers, random bf16 weights from a
     seed) served by four QuestEngines: unfused, ``fused_decode=True``,
     and ``serving_quest_config`` with bf16 and with fp8 KV: each runs
     ``generate`` on two prompts, then ``clear()`` and
     ``generate_ondevice`` on two more, with the kernel launch counts of
     each run checked against its path (the decode steps captured as CUDA
     graphs and replayed, as every later phase runs them); prefill timed
     in turns; the decode steps timed and profiled in phase 16, the
     device ops launched by an eager step checked against the path's
     (the sparse and dense kernels merge their splits in the same
     launch);
  7. the continuous-batching scheduler on the 4-layer model in f32 on
     the card against the same scheduler on the CPU's plain path,
     unfused and fused, over six requests on three slots (chunked
     prefill, an oversubscribed pool, a shared prompt prefix, an EOS
     stop, a sampled request): ticks, greedy tokens, prefix hits, block
     tables and lengths equal; then the same requests on the card with
     a bf16 KV pool, unfused and fused. In every run the scheduler's own
     kernel calls, one of each kind of batch it forms (rows prefilling,
     decode rows empty on the scratch block or inactive mid-prompt,
     rows aliasing a borrowed prefix), are copied and
     held against the plain versions within 2e-2 (:class:`KernelTap`,
     which wraps the kernels in Python, so its runs are under
     ``engine.graphs.eager()``);
  8. the scheduler serving the full-width Llama-3.1-8B (phase 6's
     weights) with ``serving_quest_config`` and bf16 KV: six requests on
     four slots, 8 usable blocks of 2048 tokens, a prefix hit; every
     tick's kernel launches checked against the path, every request's
     token count, the pool's pages after the drain, the kernel calls
     held against their plain versions as in phase 7 (batch 4); the
     smoke run's prefill tokens/s, generated tokens/s and ms a decode
     step (a few requests, mostly a draining batch: not the
     scheduler's throughput);
  9. the weight-only quantized products: ``qgemv`` (decode rows) and
     ``dequant`` (prefill rows) against their plain versions at every
     full-width linear of Llama-3.1-8B (wq/wo, wk/wv, w_gate/w_up,
     w_down, and the lm_head with an f32 activation), int8 and int4, M =
     1, 2, 4 and 16 rows: within 2e-2 (bf16) or 1e-5 (f32), dequant bit
     for bit; each timed beside its bound, its plain version and the bf16
     ``torch.matmul`` over the unquantized weight (the lm_head also beside
     ``head_gemv`` over the bf16 head, the unquantized model's route);
 10. the 4-layer f32 model with int8 and with int4 weights on the card
     against the CPU's plain path (greedy tokens equal over prefill and 8
     decode steps, logits within 2e-3, the weight kernels' launches the
     path's); AWQ at int4 on the card over the 4-layer model with salient
     activation channels: on held-out rows no linear's output error above
     RTN's;
 11. the full-width Llama-3.1-8B (phase 6's weights) quantized on the
     card to int8 and to int4, each served by a QuestEngine at B=2
     beside a bf16 engine on the same weights: launches checked (225
     qgemv and no dequant a decode step; 224 dequant and one qgemv a
     prefill chunk), finite logits, weight and pool bytes, prefill
     tokens/s and decode ms a step in turns with the bf16 engine, a
     profile, the device ops launched by phase 16's eager step held to
     QUANT_OPS_PER_STEP, and the last prefill logits' correlation with
     the bf16 engine's;
 12. the checkpoint loader: phase 6's weights as an HF-named state dict
     and Llama-3.1-8B's published config fields, loaded back on the card
     bit for bit;
 13. the eval harnesses at full width (random bf16 weights, the byte
     tokenizer; their accuracies mean nothing): perplexity with the
     sparse path live and under the dense control, passkey at two
     depths, LongBench on two synthetic tasks, every call's launches
     checked against the path;
 14. the tools (``quest_tpu_torch/scripts``) at full width over phase 6's
     weights, each through its ``run_*`` with the launches counted:
     bench_textgen at 32K (the default engine with its full-cache
     control, fused, fp8 KV and metadata at page 32, bursts of 8) and at
     131040 tokens against the control (16 tokens; launches equal to the
     path's, seconds logged), bench_kernels at its defaults, at
     32/8 heads, (append, rope, rope_prefill, rope_append) at 32/8 heads
     and B=2,
     (rms_norm, rms_norm_prefill, head_gemv) at B=2, (append_prefill,
     silu_mul, silu_mul_prefill) at a T=8192 chunk and append_prefill
     at B=2 over rows of 5000 and 2500
     (no reading above 3.35 TB/s or 989 TFLOP/s; each stage's kernel
     launched once a call), bench_serving (tokens generated and
     prefix hits), profile_textgen (every range of the unfused path with
     device time, read under ``eager()``; the captured step's device ms
     and ops), accuracy_delta (the control's delta 0, every row finite),
     accuracy_proxies on the card against the CPU (rows within 1e-3) and
     the two examples;
 15. multi-GPU: 15a a world of 1 over NCCL in this process (the sharded
     decode steps captured) against the unsharded path; 15b/15c two gloo
     ranks on the card (eager: gloo cannot be captured);
 16. the decode steps captured once as CUDA graphs and replayed
     (``quest_tpu_torch/engine/graphs.py``), held against ``eager()``,
     run on the engines and weights of the phases above: on phase 6's
     four engines and phase 11's int8 and int4 engines (B=2), 32 greedy
     tokens equal and launches equal, the logits of two decode steps bit
     for bit (else within 2e-2), wall and host-enqueue ms a step in turns
     (eager, graph, graph, eager), device busy ms and ops a step of each,
     capture seconds and pool bytes; phase 8's requests on a new
     scheduler with its steps captured: tokens (the sampled request's
     too), ticks and launches equal to phase 8's eager run; phase 14's
     bench_textgen runs (32K, the control, fused, fp8 at page 32) each
     also under ``eager()``.
 17. Mellum2-12B-A2.5B's kernels at its widths (hidden 2304, 64 experts
     of width 896, 8 a token; 32 query heads, 4 KV heads, page 16,
     64-page blocks, a 1024-token window): the router at 1, 8 and a
     chunk's 512 rows, ids equal to ``moe_route_plain``'s; the experts'
     kernels at 1 and 8 rows and the grouped products at 512 rows
     against ``moe_experts_plain`` (a per-expert loop), with idle rows
     and the count of experts read; decode and prefill attention with
     the window against their plain versions, on tables that map only
     the blocks a window layer holds (the rest point at a poisoned
     block), random queries and a case whose planted keys at the
     window's edge move the output by 4 if the edge is one key off;
     then a 4-layer Mellum2 (three window layers, one full) through
     ``ContinuousBatchingEngine`` under ``eager()``: one prefill tick
     and one decode burst, the launches of each kernel and the experts
     read against their counts. ``python3 chip_smoke.py mellum`` runs
     phases 1, 2 and 17 alone.
The line before the last is a JSON object of per-kernel numbers; the
last line is ``{"ok": true, "device": {...}}``. Without a card, or
without the package beside this script, it exits non-zero and prints
no result.
"""

import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12              # dense bf16 tensor-core peak
REL_TOL = 2e-2                   # bf16 kernel vs plain, max|d| / max|plain|
F32_TOL = 2e-3                   # f32 4-layer logits, card vs CPU
MELLUM_TOL = 5e-3                # Mellum2's kernels vs plain (phase 17)
OUT_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke"  # logs


def log(*args):
    print(*args, flush=True)


def rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def sdpa(q, k, v, **kw):
    """The library yardstick: one scaled_dot_product_attention call over
    K/V gathered densely beforehand (never called by the port)."""
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, enable_gqa=True, **kw)


def device_phase():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} visible)")
    log(smi)                    # the card's name and power limit
    return name, smi


def build_phase():
    """Builds every kernel library; returns the compiler log of each."""
    from quest_tpu_torch.ops import _build
    t0 = time.time()
    logs = _build.build()
    log(f"build: {len(logs)} kernel libraries ready in {time.time() - t0:.1f} s "
        f"(nvcc -gencode arch=compute_90a,code=sm_90a)")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "ptxas.log").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for k, v in logs.items():
        regs = [int(w.split()[0]) for w in v.split("Used ")[1:]]
        spills = [ln for ln in v.splitlines()
                  if "spill" in ln and "0 bytes spill stores, 0 bytes spill "
                  "loads" not in ln]
        log(f"  {k}: {len(regs)} kernels, at most {max(regs)} registers, "
            f"{len(spills)} with spills")
    return logs


def ptxas_kernels(text):
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes, static shared memory bytes)} from an ``-Xptxas -v`` log."""
    out, name, spill = {}, None, (0, 0)
    for ln in text.splitlines():
        if "Compiling entry function" in ln or "Function properties for" in ln:
            name = ln.split("'")[1] if "'" in ln else ln.split()[-1]
        elif "spill stores" in ln and name is not None:
            nums = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            spill = (nums[1], nums[2])
        elif "Used" in ln and "registers" in ln and name is not None:
            regs = int(ln.split("Used")[1].split()[0])
            smem = [int(w.split()[0]) for w in ln.split(",")
                    if "bytes smem" in w]
            out[name] = (regs,) + spill + (smem[0] if smem else 0,)
            spill = (0, 0)
    return out


def weight_instantiation(kind, bits, M=None, x_dtype=None):
    """The part of the mangled name of the ``csrc/qgemv.cu`` kernel a
    ``qgemv`` or ``dequant`` call launches: ``qgemv_ring_kernel<bits,
    MT>`` (bf16 x), ``qgemv_kernel<bits, MR, MG>`` (f32 x),
    ``dequant_kernel<T, bits>``."""
    if kind == "dequant":
        t = "13__nv_bfloat16" if x_dtype == torch.bfloat16 else "f"
        return f"14dequant_kernelI{t}Li{bits}EE"
    if x_dtype == torch.bfloat16:
        return f"17qgemv_ring_kernelILi{bits}ELi{8 if M <= 8 else 16}EE"
    mr, mg = next((mr, mg) for top, mr, mg in ((1, 1, 1), (2, 2, 1),
                                                (4, 4, 1), (8, 4, 2),
                                                (16, 4, 4)) if M <= top)
    return f"12qgemv_kernelILi{bits}ELi{mr}ELi{mg}EE"


def registers_of(ptxas, key):
    """'R regs, S/L spill bytes' of the kernel whose mangled name holds
    ``key``, from ``ptxas_kernels``."""
    hit = [v for k, v in ptxas.items() if key in k]
    if not hit:
        return "registers not in this build's log"
    regs, st, ld, smem = hit[0]
    return (f"{regs} registers, {smem} bytes static shared memory, "
            f"{st}/{ld} bytes spilled (stores/loads)")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.
# ---------------------------------------------------------------------------

def f32_query_check(label, kernel, plain, q, *args, **kw):
    """The kernel's f32-query branch (an f32 model's path) against its
    plain version on the same pool; returns the relative error."""
    q32 = q.float()
    err = rel_err(kernel(q32, *args, **kw), plain(q32, *args, **kw))
    log(f"{label}[f32 query]: rel err {err:.2e}")
    assert err <= REL_TOL, f"{label} kernel disagrees on an f32 query: {err}"
    return err


def make_pool(max_seq_len, B, gen, L=1, **quest_kw):
    """A Llama-3.1-8B-geometry pool filled with random K/V (bf16 unless
    ``quest_kw`` says otherwise), its page metadata, and a shuffled
    (non-identity) block table."""
    from quest_tpu_torch.config import QuestConfig, llama31_8b
    from quest_tpu_torch.kv.paged_kv import init_cache
    cfg = llama31_8b()
    quest = QuestConfig(max_seq_len=max_seq_len, **quest_kw)
    cache = init_cache(cfg, quest, batch_size=B, num_layers=L, device="cuda")
    cache.kv_pages.copy_(torch.randn(cache.kv_pages.shape, generator=gen,
                                     device="cuda"))
    kk = cache.kv_pages[:, :, :, 0].float()             # [L, Hkv, NP, page, D]
    shape = cache.k_max.shape
    cache.k_max.copy_(kk.amax(dim=3).reshape(shape))
    cache.k_min.copy_(kk.amin(dim=3).reshape(shape))
    NPB, NB = shape[2], cache.block_tab.shape[1]
    perm = torch.randperm(NPB - 1, generator=torch.Generator().manual_seed(1))
    cache.block_tab.copy_((1 + perm[:B * NB]).reshape(B, NB))
    return cfg, quest, cache


def gather_tokens(cache, b, n_tok, layer=0, kv_pages=None):
    """Row b's first n_tok tokens as dense K, V [Hkv, n_tok, D], from
    ``kv_pages`` (default: the cache's pool)."""
    page, bpp = cache.page_size, cache.block_pages
    kv_pages = cache.kv_pages if kv_pages is None else kv_pages
    lp = torch.arange((n_tok + page - 1) // page, device="cuda")
    phys = cache.block_tab[b].long()[lp // bpp] * bpp + lp % bpp
    sel = kv_pages[layer][:, phys]                    # [Hkv, n, 2, page, D]
    Hkv, D = sel.shape[0], sel.shape[-1]
    k = sel[:, :, 0].reshape(Hkv, -1, D)[:, :n_tok]
    v = sel[:, :, 1].reshape(Hkv, -1, D)[:, :n_tok]
    return k, v


def sparse_sdpa(cache, q, idx, nv, seq, kv_pages=None):
    """Library yardstick of a sparse decode: one SDPA call over the same
    selected tokens of a bf16 pool, gathered densely beforehand."""
    B, Hq, D = q.shape
    page, Hkv = cache.page_size, cache.kv_pages.shape[1]
    S = idx.shape[-1]
    Ks, Vs, masks = [], [], []
    slot = torch.arange(S, device="cuda").repeat_interleave(page)
    for b in range(B):
        k, v = gather_tokens(cache, b, cache.max_pages * page,
                             kv_pages=kv_pages)
        tok = (idx[b].long()[:, :, None] * page
               + torch.arange(page, device="cuda")).reshape(Hkv, -1)
        Ks.append(torch.gather(k, 1, tok[..., None].expand(-1, -1, D)))
        Vs.append(torch.gather(v, 1, tok[..., None].expand(-1, -1, D)))
        masks.append((slot < nv[b]) & (tok < seq[b]))
    K, V = torch.stack(Ks), torch.stack(Vs)           # [B, Hkv, S*page, D]
    mask = torch.stack(masks)                          # [B, Hkv, S*page]
    mask = mask.repeat_interleave(Hq // Hkv, 1)[:, :, None, :]  # [B,Hq,1,T]
    qs = (q.float() / math.sqrt(D)).to(torch.bfloat16)[:, :, None]
    return lambda: sdpa(qs, K, V, attn_mask=mask, scale=1.0)


def sparse_cases(timer, gen):
    from quest_tpu_torch.ops.estimate import page_scores_physical
    from quest_tpu_torch.ops.sparse_decode import (
        sparse_decode_attention, sparse_decode_attention_plain)
    from quest_tpu_torch.ops.topk import select_pages
    cfg, quest, cache = make_pool(32768, 2, gen)
    seq = torch.tensor([32768, 7001], dtype=torch.int32, device="cuda")
    B, Hq, D, page = 2, cfg.num_heads, cfg.head_dim, quest.page_size
    S = quest.page_budget
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    scores = page_scores_physical(q, cache.k_max[0], cache.k_min[0],
                                  cache.block_tab, group_agg=quest.group_agg)
    sel_idx, sel_nv = select_pages(scores, seq, page, S)
    # Injected indices: shuffled distinct pages per head, current page in.
    rng = np.random.default_rng(1)
    inj = np.zeros((B, cfg.num_kv_heads, S), np.int32)
    for b, n in enumerate(seq.tolist()):
        P_b = (n + page - 1) // page
        for h in range(cfg.num_kv_heads):
            inj[b, h] = rng.permutation(np.concatenate(
                [rng.permutation(P_b - 1)[:S - 1], [P_b - 1]]))
    inj_idx = torch.from_numpy(inj).cuda()
    inj_nv = torch.clamp((seq + page - 1) // page, max=S).to(torch.int32)
    kw = dict(sm_scale=1.0 / math.sqrt(D), layer=0,
              block_tab=cache.block_tab, block_pages=cache.block_pages)
    cases = []
    for label, idx, nv in (("select_pages", sel_idx, sel_nv),
                           ("injected", inj_idx, inj_nv)):
        got = sparse_decode_attention(q, cache.kv_pages, idx, nv, seq, **kw)
        want = sparse_decode_attention_plain(q, cache.kv_pages, idx, nv, seq,
                                             **kw)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        lib = timer(sparse_sdpa(cache, q, idx, nv, seq))
        ms = timer(lambda: sparse_decode_attention(q, cache.kv_pages, idx, nv,
                                                   seq, **kw))
        plain = timer(lambda: sparse_decode_attention_plain(
            q, cache.kv_pages, idx, nv, seq, **kw))
        n_pages = int(nv.sum()) * cfg.num_kv_heads
        nbytes = (n_pages * 2 * page * D * 2 + idx.numel() * 4
                  + q.numel() * (2 + 4))
        cases.append(dict(case=label, max_abs_err=float(
            (got - want).abs().max()), max_rel_err=err, ms=ms, plain_ms=plain,
            library_ms=lib, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes"))
        log(f"sparse[{label}]: rel err {err:.2e}, {ms * 1e3:.1f} us "
            f"(bound {cases[-1]['bound_ms'] * 1e3:.1f} us, plain "
            f"{plain * 1e3:.1f} us, SDPA {lib * 1e3:.1f} us)")
        assert err <= REL_TOL, f"sparse kernel disagrees: {err}"
    cases[0]["f32_query_rel_err"] = f32_query_check(
        "sparse", sparse_decode_attention, sparse_decode_attention_plain, q,
        cache.kv_pages, sel_idx, sel_nv, seq, **kw)
    del cache
    return cases


def dense_cases(timer, gen):
    from quest_tpu_torch.ops.dense_decode import (
        dense_decode_attention, dense_decode_attention_plain)
    cfg, quest, cache = make_pool(32768, 2, gen)
    seq = torch.tensor([32768, 5003], dtype=torch.int32, device="cuda")
    B, Hq, D = 2, cfg.num_heads, cfg.head_dim
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(sm_scale=1.0 / math.sqrt(D), layer=0,
              block_tab=cache.block_tab, block_pages=cache.block_pages)
    got = dense_decode_attention(q, cache.kv_pages, seq, **kw)
    want = dense_decode_attention_plain(q, cache.kv_pages, seq, **kw)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    n_max = int(seq.max())
    K = torch.stack([gather_tokens(cache, b, n_max)[0] for b in range(B)])
    V = torch.stack([gather_tokens(cache, b, n_max)[1] for b in range(B)])
    mask = (torch.arange(n_max, device="cuda")[None, :]
            < seq[:, None])[:, None, None, :]
    qs = (q.float() / math.sqrt(D)).to(torch.bfloat16)[:, :, None]
    lib = timer(lambda: sdpa(qs, K, V, attn_mask=mask, scale=1.0))
    ms = timer(lambda: dense_decode_attention(q, cache.kv_pages, seq, **kw))
    plain = timer(lambda: dense_decode_attention_plain(q, cache.kv_pages,
                                                       seq, **kw))
    nbytes = (int(seq.sum()) * cfg.num_kv_heads * 2 * D * 2
              + q.numel() * (2 + 4) + cache.block_tab.numel() * 4)
    case = dict(case="32768+5003", max_abs_err=float((got - want).abs().max()),
                max_rel_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
    log(f"dense: rel err {err:.2e}, {ms * 1e3:.1f} us (bound "
        f"{case['bound_ms'] * 1e3:.1f} us, plain {plain * 1e3:.1f} us, "
        f"SDPA {lib * 1e3:.1f} us)")
    assert err <= REL_TOL, f"dense kernel disagrees: {err}"
    case["f32_query_rel_err"] = f32_query_check(
        "dense", dense_decode_attention, dense_decode_attention_plain, q,
        cache.kv_pages, seq, **kw)
    return [case]


def prefill_sdpa(qs, K, V, offset):
    """Library yardsticks of a chunk's causal prefill: one SDPA call over
    K/V gathered densely beforehand, causal (``is_causal`` at offset 0,
    the bottom-right bias ``causal_lower_right`` past cached tokens),
    restricted to one backend each: flash, cuDNN and efficient attention
    (the last over K/V repeated to every query head, since it takes no
    GQA). Returns {backend: call} for the backends that accept the call;
    prefill_case keeps those that agree with the plain version."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.attention.bias import causal_lower_right
    T, G = qs.shape[2], qs.shape[1] // K.shape[1]
    kw = (dict(is_causal=True) if offset == 0 else
          dict(attn_mask=causal_lower_right(T, offset + T)))
    calls = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        gqa = backend != SDPBackend.EFFICIENT_ATTENTION
        k, v = ((K, V) if gqa else (K.repeat_interleave(G, 1),
                                    V.repeat_interleave(G, 1)))

        def call(k=k, v=v, backend=backend, gqa=gqa):
            with sdpa_kernel(backend):
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, k, v, scale=1.0, enable_gqa=gqa, **kw).transpose(1, 2)
        try:
            call()
            torch.cuda.synchronize()
            calls[backend.name] = call
        except RuntimeError as e:
            log(f"SDPA {backend.name} refused the prefill yardstick at "
                f"offset {offset}: {str(e).splitlines()[0][:160]}")
    return calls


def masked_prefill_sdpa(qs, K, V, mask):
    """Library yardsticks of a prefill over rows of several lengths: one
    SDPA call with an explicit boolean mask (causal and length, [B, 1, T,
    Tkv]), restricted to one backend each (flash takes no mask; the
    efficient kernel gets K/V repeated to every query head). Returns
    {backend: call} for the backends that accept the call."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    G = qs.shape[1] // K.shape[1]
    calls = {}
    for backend in (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION):
        gqa = backend != SDPBackend.EFFICIENT_ATTENTION
        k, v = ((K, V) if gqa else (K.repeat_interleave(G, 1),
                                    V.repeat_interleave(G, 1)))

        def call(k=k, v=v, backend=backend, gqa=gqa):
            with sdpa_kernel(backend):
                return torch.nn.functional.scaled_dot_product_attention(
                    qs, k, v, attn_mask=mask, scale=1.0,
                    enable_gqa=gqa).transpose(1, 2)
        try:
            call()
            torch.cuda.synchronize()
            calls[backend.name] = call
        except RuntimeError as e:
            log(f"SDPA {backend.name} refused the masked prefill yardstick: "
                f"{str(e).splitlines()[0][:160]}")
    return calls


def prefill_case(timer, label, q, kv_pages, off, kvl, kw, flops, nbytes,
                 library=None, bf16_pool=None):
    """One prefill case: the kernel against its plain version, timed
    beside its bound, its plain version, the fastest of the ``library``
    calls ({name: call}) that agree with the plain version within 2e-2,
    and, over an fp8 pool, its bf16 branch on ``bf16_pool``."""
    from quest_tpu_torch.ops.prefill import (prefill_attention,
                                             prefill_attention_plain)
    got = prefill_attention(q, kv_pages, off, kvl, **kw)
    want = prefill_attention_plain(q, kv_pages, off, kvl, **kw)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    ms = timer(lambda: prefill_attention(q, kv_pages, off, kvl, **kw))
    plain = timer(lambda: prefill_attention_plain(q, kv_pages, off, kvl,
                                                  **kw))
    libs = {}
    for name, call in (library or {}).items():
        lerr = rel_err(call(), want)
        if lerr <= REL_TOL:
            libs[name] = timer(call)
        else:
            log(f"prefill[{label}]: SDPA {name} differs from the plain "
                f"version ({lerr:.2e}); not a yardstick")
    lib = min(libs.values()) if libs else None
    bound = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    case = dict(case=label, max_abs_err=float((got - want).abs().max()),
                max_rel_err=err, ms=ms, plain_ms=plain, library_ms=lib,
                library_backend=min(libs, key=libs.get) if libs else None,
                library_ms_by_backend=libs, bound_ms=bound,
                bound_by="operations", gflop=flops / 1e9,
                tflops=flops / ms / 1e9)
    extra = ""
    if bf16_pool is not None:
        case["bf16_ms"] = timer(lambda: prefill_attention(q, bf16_pool, off,
                                                          kvl, **kw))
        extra = f", bf16 branch {case['bf16_ms']:.3f} ms"
    log(f"prefill[{label}]: rel err {err:.2e}, {ms:.3f} ms "
        f"({case['tflops']:.1f} TFLOP/s; bound {bound:.3f} ms, plain "
        f"{plain:.3f} ms, SDPA " + (", ".join(
            f"{k} {v:.3f} ms" for k, v in libs.items()) or "none")
        + f"{extra})")
    assert err <= REL_TOL, f"prefill kernel disagrees ({label}): {err}"
    return case


def causal_pairs(T, offset, kv_len):
    """(q, k) pairs the kernel computes for one row: query i sees keys
    k <= offset + i and k < kv_len (padded rows see every cached key)."""
    i = np.arange(T)
    return int(np.minimum(offset + i + 1, kv_len).sum())


def prefill_cases(timer, gen):
    from quest_tpu_torch.ops.prefill import (prefill_attention,
                                             prefill_attention_plain)
    cfg, quest, cache = make_pool(8192, 2, gen)
    Hq, Hkv, D, T = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, 2048
    kw = dict(sm_scale=1.0 / math.sqrt(D), layer=0,
              block_tab=cache.block_tab[:1], block_pages=cache.block_pages)
    cases = []
    for offset in (0, 4096):
        q = torch.randn((1, T, Hq, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        off = torch.tensor([offset], dtype=torch.int32, device="cuda")
        kvl = off + T
        K, V = gather_tokens(cache, 0, offset + T)
        qs = (q.float() / math.sqrt(D)).to(torch.bfloat16).transpose(1, 2)
        lib = prefill_sdpa(qs, K[None], V[None], offset)
        # The earlier yardstick, SDPA left to choose its backend, with a
        # dense boolean mask past cached tokens (which keeps it off
        # flash); logged once beside the calls above.
        mask = (torch.arange(offset + T, device="cuda")[None, :]
                <= offset + torch.arange(T, device="cuda")[:, None])
        old_kw = dict(is_causal=True) if offset == 0 else dict(attn_mask=mask)
        old = timer(lambda: sdpa(qs, K[None], V[None], scale=1.0, **old_kw))
        log(f"prefill[offset {offset}]: SDPA on its default backend "
            f"({'is_causal' if offset == 0 else 'boolean mask'}) "
            f"{old:.3f} ms")
        flops = 4 * Hq * D * causal_pairs(T, offset, offset + T)
        nbytes = (offset + T) * Hkv * 2 * D * 2 + q.numel() * (2 + 4)
        cases.append(prefill_case(timer, f"T=2048 offset={offset}", q,
                                  cache.kv_pages, off, kvl, kw, flops,
                                  nbytes, lib))
        cases[-1]["default_sdpa_ms"] = old
        cases[-1]["f32_query_rel_err"] = f32_query_check(
            f"prefill[offset {offset}]", prefill_attention,
            prefill_attention_plain, q, cache.kv_pages, off, kvl, **kw)
    # The serving phase's prefill shape: rows of 5000 and 2500 tokens in a
    # 5120-token bucket; the short row's 2620 padded rows see its 2500 keys.
    T, lens = 5120, (5000, 2500)
    q = torch.randn((2, T, Hq, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    off = torch.zeros(2, dtype=torch.int32, device="cuda")
    kvl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    flops = 4 * Hq * D * sum(causal_pairs(T, 0, n) for n in lens)
    nbytes = sum(lens) * Hkv * 2 * D * 2 + q.numel() * (2 + 4)
    # Yardstick: one SDPA call over both rows' keys (5000 each, the short
    # row's past 2500 masked) with the causal-and-length boolean mask.
    n_max = max(lens)
    K = torch.stack([gather_tokens(cache, b, n_max)[0] for b in range(2)])
    V = torch.stack([gather_tokens(cache, b, n_max)[1] for b in range(2)])
    k_pos = torch.arange(n_max, device="cuda")
    mask = ((k_pos[None, None, :] <= torch.arange(T, device="cuda")[None, :,
                                                                    None])
            & (k_pos[None, None, :] < kvl[:, None, None]))[:, None]
    qs = (q.float() / math.sqrt(D)).to(torch.bfloat16).transpose(1, 2)
    cases.append(prefill_case(timer, "serving shape B=2 T=5120 kv 5000+2500",
                              q, cache.kv_pages, off, kvl,
                              dict(kw, block_tab=cache.block_tab), flops,
                              nbytes, masked_prefill_sdpa(qs, K, V, mask)))
    del K, V, mask, qs
    del cache
    return cases


def tie_rows():
    """The boundary-tie rows of the JAX select's tests (scores, K,
    seq_len at page 16): all-equal scores, a 190-way tie band across the
    boundary, negative ties and zeros, a single-page row."""
    s2 = torch.zeros(256)
    s2[:10] = 7.0
    s2[10:200] = 3.25
    s3 = torch.cat([torch.full((128,), -2.5), torch.zeros(128)])
    return [(torch.full((256,), 1.5), 40, 256 * 16), (s2, 64, 256 * 16),
            (s3, 130, 256 * 16 - 3), (torch.linspace(0, 1, 128), 8, 5)]


def fused_slice_cases(timer, gen):
    """The fused path's three kernels at the sparse case's shapes
    (B=2, 32768 + 7001 tokens in a 32768-token pool, shuffled block
    table, bf16 query): the streaming estimate over the rows' logical
    metadata, the select over [2, 8, 2048] random scores and the tie
    rows, and the fused decode with its selected ids."""
    from quest_tpu_torch.ops.estimate import (page_scores_kernel,
                                              page_scores_kernel_plain,
                                              page_scores_physical)
    from quest_tpu_torch.ops.fused_decode import (
        exact_topk_select, exact_topk_select_plain, fused_sparse_decode,
        fused_sparse_decode_plain, slot_page_scores)
    from quest_tpu_torch.ops.reference import selection_flips
    from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
    from quest_tpu_torch.ops.topk import select_pages
    cfg, quest, cache = make_pool(32768, 2, gen)
    seq = torch.tensor([32768, 7001], dtype=torch.int32, device="cuda")
    B, Hq, Hkv, D = 2, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G, page, K, agg = Hq // Hkv, quest.page_size, quest.page_budget, \
        quest.group_agg
    P = cache.max_pages
    n = (seq.long() + page - 1) // page                      # [B] pages
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    out = {}

    # Streaming estimate over each row's logical metadata [B, Hkv, P, D].
    phys = (cache.block_tab.long()[:, :, None] * cache.block_pages
            + torch.arange(cache.block_pages, device="cuda")).reshape(B, P)
    km = cache.k_max[0].reshape(Hkv, -1, D)[:, phys].transpose(0, 1).contiguous()
    kn = cache.k_min[0].reshape(Hkv, -1, D)[:, phys].transpose(0, 1).contiguous()
    errs = {}
    for qd in (torch.float32, torch.bfloat16):
        qq = q.to(qd)
        got = page_scores_kernel(qq, km, kn, agg)
        want = page_scores_kernel_plain(qq, km, kn, agg)
        torch.cuda.synchronize()
        errs[qd] = (rel_err(got, want), float((got - want).abs().max()))
        assert errs[qd][0] <= 1e-5, f"estimate kernel disagrees: {errs[qd]}"
    # Library yardstick: one bmm over operands concatenated beforehand.
    qc = torch.cat([q.float().clamp(min=0), q.float().clamp(max=0)],
                   dim=-1).to(torch.bfloat16).reshape(B * Hkv, G, 2 * D)
    mc = torch.cat([km, kn], dim=-1).reshape(B * Hkv, P, 2 * D).transpose(
        1, 2).contiguous()
    lib = timer(lambda: torch.bmm(qc, mc))
    # An empty launch under the same timer: the floor every time stands on.
    empty_ms = timer(lambda: torch.cuda._sleep(1))
    ms = timer(lambda: page_scores_kernel(q, km, kn, agg))
    plain = timer(lambda: page_scores_kernel_plain(q, km, kn, agg))
    nbytes = 2 * km.numel() * 2 + q.numel() * 2 + B * Hkv * P * 4
    flops = 2 * 2 * B * Hq * P * D
    bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    out["estimate"] = [dict(
        case="B=2, 2048 pages, bf16 metadata", max_abs_err=errs[torch.bfloat16][1],
        max_rel_err=max(e[0] for e in errs.values()), ms=ms, plain_ms=plain,
        library_ms=lib, bound_ms=bound, bound_by="bytes",
        f32_query_rel_err=errs[torch.float32][0], empty_launch_ms=empty_ms)]
    log(f"estimate: rel err {errs[torch.float32][0]:.2e} (f32 query), "
        f"{errs[torch.bfloat16][0]:.2e} (bf16 query), {ms * 1e3:.2f} us "
        f"(bound {bound * 1e3:.2f} us, plain {plain * 1e3:.1f} us, bmm "
        f"{lib * 1e3:.2f} us; an empty launch {empty_ms * 1e3:.2f} us)")
    # A page count off the kernel's 16-page tiles (a ragged last tile).
    Pr = P - 13
    kmr, knr = km[:, :, :Pr].contiguous(), kn[:, :, :Pr].contiguous()
    got = page_scores_kernel(q, kmr, knr, agg)
    want = page_scores_kernel_plain(q, kmr, knr, agg)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    assert err <= 1e-5, f"estimate kernel disagrees at P={Pr}: {err}"
    msr = timer(lambda: page_scores_kernel(q, kmr, knr, agg))
    out["estimate"].append(dict(
        case=f"B=2, {Pr} pages, bf16 metadata", max_abs_err=float(
            (got - want).abs().max()), max_rel_err=err, ms=msr,
        plain_ms=timer(lambda: page_scores_kernel_plain(q, kmr, knr, agg)),
        library_ms=None, bound_ms=(2 * kmr.numel() * 2 + q.numel() * 2
                                   + B * Hkv * Pr * 4) / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes"))
    log(f"estimate[P={Pr}]: rel err {err:.2e}, {msr * 1e3:.1f} us")
    del km, kn, mc, kmr, knr

    # Select: random scores of every (row, head), then the tie rows.
    scores = torch.randn((B * Hkv, P), generator=gen, device="cuda")
    npr = n.repeat_interleave(Hkv)
    ids, nv = exact_topk_select(scores, npr, K)
    want, want_nv = exact_topk_select_plain(scores, npr, K)
    torch.cuda.synchronize()
    assert torch.equal(ids, want) and torch.equal(nv, want_nv), \
        "select kernel ids differ from the plain version"
    for s, k, sl in tie_rows():
        s, m = s.cuda()[None], torch.tensor([(sl + 15) // 16], device="cuda")
        got, want_t = exact_topk_select(s, m, k), exact_topk_select_plain(s, m, k)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want_t)), \
            f"select kernel differs on a tie row (K={k})"
    lib = timer(lambda: torch.topk(scores, K, dim=-1))
    ms = timer(lambda: exact_topk_select(scores, npr, K))
    plain = timer(lambda: exact_topk_select_plain(scores, npr, K))
    nbytes = scores.numel() * 4 + ids.numel() * 4 + 2 * npr.numel() * 4
    out["topk_select"] = [dict(
        case="[16, 2048] random scores + 4 tie rows, K=128",
        max_abs_err=0.0, max_rel_err=0.0, bitwise_equal=True, ms=ms,
        plain_ms=plain, library_ms=lib,
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")]
    log(f"topk_select: ids bitwise equal (random rows and 4 tie rows), "
        f"{ms * 1e3:.1f} us (bound {out['topk_select'][0]['bound_ms'] * 1e3:.2f}"
        f" us, plain {plain * 1e3:.1f} us, torch.topk {lib * 1e3:.1f} us)")

    # Fused decode, and the unfused pipeline on the same inputs.
    kw = dict(sm_scale=1.0 / math.sqrt(D), budget_pages=K, group_agg=agg,
              layer=0, block_tab=cache.block_tab,
              block_pages=cache.block_pages)
    args = (cache.kv_pages, cache.k_max, cache.k_min, seq)
    got, got_ids = fused_sparse_decode(q, *args, return_ids=True, **kw)
    want, want_ids = fused_sparse_decode_plain(q, *args, return_ids=True, **kw)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    plain_scores = slot_page_scores(q, cache.k_max, cache.k_min, layer=0,
                                    block_tab=cache.block_tab,
                                    block_pages=cache.block_pages,
                                    group_agg=agg)
    flips, gap = selection_flips(got_ids.reshape(B * Hkv, K),
                                 want_ids.reshape(B * Hkv, K),
                                 plain_scores.reshape(B * Hkv, P), npr)
    log(f"fused: rel err {err:.2e}; {flips} selected ids differ from the "
        f"plain selection (largest distance from the K-th score "
        f"{gap:.1e} relative, limit 1e-5)")
    assert err <= REL_TOL, f"fused kernel disagrees: {err}"
    assert flips == 0 or gap <= 1e-5, f"fused selection differs: {flips}, {gap}"
    f32_err = f32_query_check("fused", fused_sparse_decode,
                              fused_sparse_decode_plain, q, *args, **kw)

    def unfused():
        s = page_scores_physical(q, cache.k_max[0], cache.k_min[0],
                                 cache.block_tab, group_agg=agg)
        idx, nvv = select_pages(s, seq, page, K)
        return sparse_decode_attention(q, cache.kv_pages, idx, nvv, seq,
                                       sm_scale=kw["sm_scale"], layer=0,
                                       block_tab=cache.block_tab,
                                       block_pages=cache.block_pages)

    ms = timer(lambda: fused_sparse_decode(q, *args, **kw))
    # The same call at an 8-page budget: scoring and select at full cost,
    # 1/16 of the attention; the difference is the attention's share.
    ms8 = timer(lambda: fused_sparse_decode(q, *args, **dict(
        kw, budget_pages=8)))
    pipe = timer(unfused)
    plain = timer(lambda: fused_sparse_decode_plain(q, *args, **kw))
    nbytes = (Hkv * int(n.sum()) * 2 * D * 2
              + Hkv * int(n.clamp(max=K).sum()) * 2 * page * D * 2
              + q.numel() * 2 + B * Hq * D * 4 + cache.block_tab.numel() * 4)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    select_ms = out["topk_select"][0]["ms"]
    out["fused_decode"] = [dict(
        case="B=2, 32768+7001 tokens, 128 pages", max_abs_err=float(
            (got - want).abs().max()), max_rel_err=err, ms=ms, plain_ms=plain,
        library_ms=None, unfused_pipeline_ms=pipe, budget8_ms=ms8,
        select_alone_ms=select_ms, bound_ms=bound,
        bound_by="bytes", flipped_ids=flips, flip_max_rel_gap=gap,
        f32_query_rel_err=f32_err)]
    log(f"fused: {ms * 1e3:.1f} us (bound {bound * 1e3:.1f} us, plain "
        f"{plain * 1e3:.1f} us, unfused pipeline {pipe * 1e3:.1f} us; no "
        f"single library call computes it); at an 8-page budget "
        f"{ms8 * 1e3:.1f} us; the select alone (16 rows, 2048 pages) "
        f"{select_ms * 1e3:.1f} us")
    out["fused_decode"].append(fused_serving_rows(timer, cache, q, kw, P))
    out["fused_decode"].append(fused_tie_rows(cache, q, kw))
    del cache
    out["fused_decode"].append(fused_page8_case(timer, gen))
    return out


def fused_page8_case(timer, gen):
    """The fused kernel over a pool of 8-token pages (two pages an
    attention chunk; the budget of 2048 tokens is 256 pages), B=2, 32768 +
    7001 tokens, bf16, held to its plain version; returns the case."""
    from quest_tpu_torch.ops.fused_decode import (fused_sparse_decode,
                                                  fused_sparse_decode_plain,
                                                  slot_page_scores)
    from quest_tpu_torch.ops.reference import selection_flips
    cfg, quest, cache = make_pool(32768, 2, gen, page_size=8)
    seq = torch.tensor([32768, 7001], dtype=torch.int32, device="cuda")
    B, Hq, Hkv, D = 2, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    page, K, P = quest.page_size, quest.page_budget, cache.max_pages
    q = torch.randn((B, Hq, D), generator=gen, device="cuda").to(torch.bfloat16)
    kw = dict(sm_scale=1.0 / math.sqrt(D), budget_pages=K,
              group_agg=quest.group_agg, layer=0, block_tab=cache.block_tab,
              block_pages=cache.block_pages)
    args = (cache.kv_pages, cache.k_max, cache.k_min, seq)
    got, ids = fused_sparse_decode(q, *args, return_ids=True, **kw)
    want, want_ids = fused_sparse_decode_plain(q, *args, return_ids=True,
                                               **kw)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    scores = slot_page_scores(q, cache.k_max, cache.k_min, layer=0,
                              block_tab=cache.block_tab,
                              block_pages=cache.block_pages,
                              group_agg=quest.group_agg)
    n = (seq.long() + page - 1) // page
    flips, gap = selection_flips(ids.reshape(B * Hkv, K),
                                 want_ids.reshape(B * Hkv, K),
                                 scores.reshape(B * Hkv, P),
                                 n.repeat_interleave(Hkv))
    assert err <= REL_TOL, f"fused kernel disagrees at page 8: {err}"
    assert flips == 0 or gap <= 1e-5, f"fused selection differs: {flips}, {gap}"
    ms = timer(lambda: fused_sparse_decode(q, *args, **kw))
    plain = timer(lambda: fused_sparse_decode_plain(q, *args, **kw))
    nbytes = (Hkv * int(n.sum()) * 2 * D * 2
              + Hkv * int(n.clamp(max=K).sum()) * 2 * page * D * 2
              + q.numel() * 2 + q.numel() * 4 + cache.block_tab.numel() * 4)
    log(f"fused[page 8, {K} pages]: rel err {err:.2e}, {flips} ids differ "
        f"(gap {gap:.1e}), {ms * 1e3:.1f} us (bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e6:.1f} us, plain {plain * 1e3:.1f} "
        f"us)")
    del cache
    torch.cuda.empty_cache()
    return dict(case=f"page 8, B=2, 32768+7001 tokens, {K} pages",
                max_abs_err=float((got - want).abs().max()),
                max_rel_err=err, ms=ms, plain_ms=plain, library_ms=None,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                flipped_ids=flips, flip_max_rel_gap=gap)


def fused_serving_rows(timer, cache, q, kw, P):
    """The fused kernel at the serving run's row lengths (the 6000- and
    3000-token prompts of ``generate``), held to its plain version like
    the kernel case; returns the case."""
    from quest_tpu_torch.ops.fused_decode import (fused_sparse_decode,
                                                  fused_sparse_decode_plain,
                                                  slot_page_scores)
    from quest_tpu_torch.ops.reference import selection_flips
    seq = torch.tensor([6000, 3000], dtype=torch.int32, device="cuda")
    B, Hkv = seq.numel(), cache.kv_pages.shape[1]
    K, page, D = kw["budget_pages"], cache.page_size, q.shape[-1]
    args = (cache.kv_pages, cache.k_max, cache.k_min, seq)
    got, ids = fused_sparse_decode(q, *args, return_ids=True, **kw)
    want, want_ids = fused_sparse_decode_plain(q, *args, return_ids=True,
                                               **kw)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    scores = slot_page_scores(q, cache.k_max, cache.k_min, layer=0,
                              block_tab=cache.block_tab,
                              block_pages=cache.block_pages,
                              group_agg=kw["group_agg"])
    n = (seq.long() + page - 1) // page
    flips, gap = selection_flips(ids.reshape(B * Hkv, K),
                                 want_ids.reshape(B * Hkv, K),
                                 scores.reshape(B * Hkv, P),
                                 n.repeat_interleave(Hkv))
    assert err <= REL_TOL, f"fused kernel disagrees at 6000/3000: {err}"
    assert flips == 0 or gap <= 1e-5, f"fused selection differs: {flips}, {gap}"
    ms = timer(lambda: fused_sparse_decode(q, *args, **kw))
    nbytes = (Hkv * int(n.sum()) * 2 * D * 2
              + Hkv * int(n.clamp(max=K).sum()) * 2 * page * D * 2
              + q.numel() * 2 + q.numel() * 4 + cache.block_tab.numel() * 4)
    log(f"fused[6000+3000 tokens]: rel err {err:.2e}, {flips} ids differ "
        f"(gap {gap:.1e}), {ms * 1e3:.1f} us (bound "
        f"{nbytes / HBM_BYTES_PER_S * 1e6:.1f} us)")
    return dict(case="B=2, 6000+3000 tokens (the serving run's rows)",
                max_abs_err=float((got - want).abs().max()),
                max_rel_err=err, ms=ms, plain_ms=None, library_ms=None,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                flipped_ids=flips, flip_max_rel_gap=gap)


def fused_tie_rows(cache, q, kw):
    """The fused kernel on the select's tie rows: every row's metadata
    holds the tie row's score / (G * 128) on every dimension of a page
    and the query is all ones, so the kernel's scores are exactly the tie
    row's (sum over the group) and its ids must equal the plain
    selection bit for bit. Returns the case (no timing)."""
    from quest_tpu_torch.ops.fused_decode import (fused_sparse_decode,
                                                  fused_sparse_decode_plain)
    Hkv, D = cache.kv_pages.shape[1], q.shape[-1]
    G = q.shape[1] // Hkv
    bpp, B = cache.block_pages, q.shape[0]
    phys = (cache.block_tab.long()[:, :, None] * bpp
            + torch.arange(bpp, device="cuda")).reshape(B, -1)
    ones = torch.ones_like(q)
    worst = 0.0
    for s, k, sl in tie_rows():
        meta = torch.zeros(cache.k_max.shape, device="cuda").reshape(
            Hkv, -1, D)
        lev = (s.cuda() / (G * D)).to(cache.k_max.dtype).float()
        for b in range(B):
            meta[:, phys[b, :lev.numel()]] = lev[None, :, None].expand(
                Hkv, -1, D)
        meta = meta.to(cache.k_max.dtype).reshape(cache.k_max.shape)
        seq = torch.full((B,), sl, dtype=torch.int32, device="cuda")
        kwt = dict(kw, budget_pages=k, group_agg="sum", return_ids=True)
        got, ids = fused_sparse_decode(ones, cache.kv_pages, meta, meta, seq,
                                       **kwt)
        want, want_ids = fused_sparse_decode_plain(ones, cache.kv_pages, meta,
                                                   meta, seq, **kwt)
        torch.cuda.synchronize()
        assert torch.equal(ids, want_ids), \
            f"fused ids differ from the plain selection on a tie row (K={k})"
        worst = max(worst, rel_err(got, want))
    assert worst <= REL_TOL, f"fused kernel disagrees on a tie row: {worst}"
    log(f"fused[tie rows]: ids bitwise equal on {len(tie_rows())} tie rows "
        f"(all rows of the batch, every KV head), rel err {worst:.2e}")
    return dict(case="4 tie rows, all heads, ids bitwise", max_abs_err=None,
                max_rel_err=worst, ms=None, plain_ms=None, library_ms=None,
                bound_ms=None, bound_by="bytes", bitwise_equal=True)


F32_FLOPS = 67e12                # f32 FMA peak outside the tensor cores


def bmm_yardstick(q, k_max_l, k_min_l, block_tab):
    """The estimate's library yardstick: the operands of one f32
    ``torch.bmm`` over the rows' metadata, gathered through the block
    table and widened beforehand, whose product [B * Hkv, G, P] is the
    physical route's per-query-head scores. Returns (qc, mc)."""
    Hkv, _, bpp, D = k_max_l.shape
    B, Hq, _ = q.shape
    P = block_tab.shape[1] * bpp
    phys = (block_tab.long()[:, :, None] * bpp
            + torch.arange(bpp, device=q.device)).reshape(B, P)
    m = torch.cat([k_max_l, k_min_l], dim=-1).reshape(
        Hkv, -1, 2 * D)[:, phys].float()                   # [Hkv, B, P, 2D]
    mc = m.transpose(0, 1).reshape(B * Hkv, P, 2 * D).transpose(
        1, 2).contiguous()
    qf = q.float().reshape(B * Hkv, Hq // Hkv, D)
    return torch.cat([qf.clamp(min=0), qf.clamp(max=0)], dim=-1), mc


def scratch_and_shared(cache, seq):
    """Rewrites the block table as the scheduler leaves it: every block
    past a row's length on the scratch block 0, and row 1's first block
    the same physical block as row 0's (a shared prompt prefix)."""
    bt = cache.block_pages * cache.page_size
    tab = cache.block_tab
    for b, n in enumerate(seq.tolist()):
        tab[b, -(-n // bt):] = 0
    if tab.shape[0] > 1:
        tab[1, 0] = tab[0, 0]


def selection_cases(timer, gen, ptxas):
    """The unfused decode step's selection on its kernels at the main
    path's shapes (Llama-3.1-8B attention, 64-page blocks, a shuffled
    block table): the estimate's physical route against
    ``page_scores_physical_plain`` (within 1e-5 relative; bf16 metadata
    at page 16, B=1 over 32768 and over 131072 tokens, and B=2 with rows
    of 5000 and 2500 in a 16384-token pool whose idle blocks sit on
    scratch block 0 and whose rows share a block; fp8 metadata at page
    32; per query head; group sum; groups of 3 and 1; bf16 and f32
    queries; the 256 fp8 codes widened exactly), and ``select_pages`` on the card (the select
    kernel with junk id P - 1) against ``select_pages_plain``: ids and
    num_valid bit for bit, junk slots included, on those scores and on
    rows of 0, 1 and 17 tokens, K > P and the tie rows. The pipeline as
    a whole against the plain one: no selected id flipped outside 1e-5
    of the K-th score. Timed in turns with the plain versions and a
    library call (``torch.bmm`` over metadata gathered and widened
    beforehand; ``torch.topk``); the estimate, a streaming kernel, under
    ``timer``'s memset flush (its ``ms``, ``plain_ms`` and ``library_ms``,
    as every row) and under ``Timer(flush="read")`` (``read_ms``,
    ``read_plain_ms``, ``read_library_ms``). ``ptxas``: ``ptxas_kernels``
    of the estimate library, whose physical route's registers and shared
    memory are logged beside each case's launch plan."""
    from quest_tpu_torch.ops.estimate import (page_scores_physical,
                                              page_scores_physical_plain,
                                              physical_plan)
    from quest_tpu_torch.ops.reference import selection_flips
    from quest_tpu_torch.ops.topk import select_pages, select_pages_plain
    from quest_tpu_torch.utils.benchmarking import Timer, in_turns
    out = {"estimate": [], "topk_select": []}
    D = 128
    read_timer = Timer(flush="read")
    for t, key in (("f32", "IfE"), ("bf16", "I13__nv_bfloat16E"),
                   ("fp8", "I13__nv_fp8_e4m3E")):
        log(f"estimate[physical, {t} metadata]: "
            + registers_of(ptxas, "estimate_physical_kernel" + key))

    def est(label, q, cache, agg="max", per_q=False, timed=False):
        args = (q, cache.k_max[0], cache.k_min[0], cache.block_tab)
        kw = dict(group_agg=agg, per_q_head=per_q)
        got = page_scores_physical(*args, **kw)
        want = page_scores_physical_plain(*args, **kw)
        torch.cuda.synchronize()
        err = rel_err(got, want)
        assert err <= 1e-5, f"physical estimate disagrees ({label}): {err}"
        B, Hq, _ = q.shape
        Hkv, _, bpp, _ = cache.k_max.shape[1:]
        P = cache.block_tab.shape[1] * bpp
        blocks = torch.unique(cache.block_tab).numel()
        nbytes = (q.numel() * q.element_size() + cache.block_tab.numel() * 4
                  + 2 * Hkv * blocks * bpp * D * cache.k_max.element_size()
                  + got.numel() * 4)
        flops = 2 * 2 * B * Hq * P * D
        row = dict(case=label, max_abs_err=float((got - want).abs().max()),
                   max_rel_err=err, ms=None, plain_ms=None, library_ms=None,
                   bound_ms=max(nbytes / HBM_BYTES_PER_S,
                                flops / F32_FLOPS) * 1e3,
                   bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                   >= flops / F32_FLOPS else "operations")
        plan = physical_plan(cache.k_max[0], B, cache.block_tab.shape[1],
                             Hq // Hkv)
        if timed:
            qc, mc = bmm_yardstick(*args)
            fns = {"ms": lambda: page_scores_physical(*args, **kw),
                   "plain_ms": lambda: page_scores_physical_plain(*args,
                                                                  **kw),
                   "library_ms": lambda: torch.bmm(qc, mc)}
            tm = in_turns(timer, fns)
            t = in_turns(read_timer, fns)
            row.update({k: statistics.mean(v) for k, v in tm.items()},
                       **{"read_" + k: statistics.mean(v)
                          for k, v in t.items()},
                       turns_ms={"memset": tm, "read": t})
            del mc
        out["estimate"].append(row)
        us = (lambda k: f"{row[k] * 1e3:.2f} / "
              f"{row['read_' + k] * 1e3:.2f}")
        log(f"estimate[physical, {label}]: rel err {err:.2e}; plan {plan}"
            + (f"; us, memset / read flush: {us('ms')} (bound "
               f"{row['bound_ms'] * 1e3:.2f} us), plain {us('plain_ms')}, "
               f"f32 bmm {us('library_ms')}; turns "
               f"{json.dumps(row['turns_ms'])}" if timed else ""))
        return got, want

    def sel(label, scores, seq, page, K, timed=False):
        got = select_pages(scores, seq, page, K)
        want = select_pages_plain(scores, seq, page, K)
        torch.cuda.synchronize()
        same = all(torch.equal(x, y) for x, y in zip(got, want))
        assert same, f"select kernel ids or num_valid differ ({label})"
        B, H, P = scores.shape
        n = ((seq.long() + page - 1) // page).clamp(max=P)
        nbytes = (int(n.sum()) * H * 4 + B * H * K * 4 + 2 * B * 4)
        row = dict(case=label, max_abs_err=0.0, max_rel_err=0.0,
                   bitwise_equal=True, ms=None, plain_ms=None,
                   library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        if timed:
            t = in_turns(timer, {
                "ms": lambda: select_pages(scores, seq, page, K),
                "plain_ms": lambda: select_pages_plain(scores, seq, page, K),
                "library_ms": lambda: torch.topk(scores, K, dim=-1)})
            row.update({k: statistics.mean(v) for k, v in t.items()},
                       turns_ms=t)
        out["topk_select"].append(row)
        log(f"topk_select[select_pages, {label}]: ids and num_valid bitwise "
            f"equal" + (f", {row['ms'] * 1e3:.1f} us (bound "
                        f"{row['bound_ms'] * 1e3:.3f} us, plain "
                        f"{row['plain_ms'] * 1e3:.1f} us, torch.topk "
                        f"{row['library_ms'] * 1e3:.1f} us; turns "
                        f"{json.dumps(row['turns_ms'])})" if timed else ""))
        return got

    def flips(label, got_ids, want_ids, scores, seq, page):
        B, H, P = scores.shape
        K = got_ids.shape[-1]
        n = ((seq.long() + page - 1) // page).repeat_interleave(H)
        c, gap = selection_flips(got_ids.reshape(B * H, K),
                                 want_ids.reshape(B * H, K),
                                 scores.reshape(B * H, P), n)
        log(f"selection[{label}]: kernels vs the plain pipeline: {c} ids "
            f"differ (largest distance from the K-th score {gap:.1e} "
            f"relative, limit 1e-5)")
        assert c == 0 or gap <= 1e-5, f"selection flips ({label}): {c}, {gap}"
        return dict(flipped_ids=c, flip_max_rel_gap=gap)

    def route(label, q, cache, seq, agg="max", per_q=False, timed=False):
        page = cache.page_size
        K = 2048 // page                   # the default 2048-token budget
        got, want = est(label, q, cache, agg, per_q, timed)
        ids = sel(label, got, seq, page, K, timed)
        want_ids, _ = select_pages_plain(want, seq, page, K)
        out["topk_select"][-1].update(flips(label, ids[0], want_ids, want,
                                            seq, page))

    # The bench_textgen --ab-full shape: B=1, 32768 tokens, page 16.
    cfg, quest, cache = make_pool(32768, 1, gen)
    seq = torch.tensor([32768], dtype=torch.int32, device="cuda")
    q = torch.randn((1, 32, D), generator=gen, device="cuda")
    route("B=1, 32768 tokens, bf16 page 16", q.to(torch.bfloat16), cache,
          seq, timed=True)
    est("B=1, 32768 tokens, bf16 page 16, f32 query", q, cache)
    del cache
    # The longest context of Llama-3.1-8B: 131072 positions, 33.5 MB of
    # metadata a layer.
    cfg, quest, cache = make_pool(131072, 1, gen)
    seq = torch.tensor([131072], dtype=torch.int32, device="cuda")
    q = torch.randn((1, 32, D), generator=gen, device="cuda")
    route("B=1, 131072 tokens, bf16 page 16", q.to(torch.bfloat16), cache,
          seq, timed=True)
    del cache
    torch.cuda.empty_cache()
    # The serving phase's rows in its 16384-token pool, idle blocks on
    # scratch, a shared block.
    cfg, quest, cache = make_pool(16384, 2, gen)
    seq = torch.tensor([5000, 2500], dtype=torch.int32, device="cuda")
    scratch_and_shared(cache, seq)
    q = torch.randn((2, 32, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    route("B=2, 5000+2500 tokens, bf16 page 16", q, cache, seq, timed=True)
    route("B=2, 5000+2500 tokens, group sum", q, cache, seq, agg="sum")
    route("B=2, 5000+2500 tokens, per query head", q, cache, seq,
          per_q=True)
    for G in (3, 1):
        qg = torch.randn((2, 8 * G, D), generator=gen, device="cuda").to(
            torch.bfloat16)
        route(f"B=2, 5000+2500 tokens, group {G}", qg, cache, seq)
    # Rows of 0, 1 and 17 tokens (an idle slot, one page, two pages) and
    # a full one; K above the page count.
    scores = torch.randn((4, 8, cache.max_pages), generator=gen,
                         device="cuda")
    seq4 = torch.tensor([0, 1, 17, 16384], dtype=torch.int32, device="cuda")
    sel("rows of 0, 1, 17 and 16384 tokens", scores, seq4, 16, 128)
    sel("K=128 over 100 pages", scores[:2, :, :100].contiguous(),
        torch.tensor([1600, 800], dtype=torch.int32, device="cuda"), 16, 128)
    for s, k, sl in tie_rows():
        sel(f"tie row, K={k}", s.cuda()[None, None],
            torch.tensor([sl], dtype=torch.int32, device="cuda"), 16, k)
    del cache
    # The serving configuration's metadata: fp8 e4m3 at page 32.
    cfg, quest, cache = make_pool(32768, 1, gen, page_size=32,
                                  meta_dtype=torch.float8_e4m3fn)
    seq = torch.tensor([32768], dtype=torch.int32, device="cuda")
    q = torch.randn((1, 32, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    route("B=1, 32768 tokens, fp8 page 32", q, cache, seq, timed=True)
    del cache
    torch.cuda.empty_cache()
    # Every fp8 code, denormals and NaNs included, widened exactly: page p
    # holds code p in k_max's dim 0 and k_min's dim 5; query head 0 reads
    # dim 0, head 1 dim 5 negated (per query head, G=2).
    codes = torch.arange(256, dtype=torch.uint8, device="cuda")
    kx = torch.zeros((1, 4, 64, D), dtype=torch.uint8, device="cuda")
    kn = torch.zeros_like(kx)
    kx.view(256, D)[:, 0] = codes
    kn.view(256, D)[:, 5] = codes
    kx, kn = (t.view(torch.float8_e4m3fn) for t in (kx, kn))
    qc = torch.zeros((1, 2, D), device="cuda")
    qc[0, 0, 0], qc[0, 1, 5] = 1.0, -1.0
    tab = torch.tensor([[2, 0, 3, 1]], dtype=torch.int32, device="cuda")
    got = page_scores_physical(qc, kx, kn, tab, per_q_head=True)
    want = page_scores_physical_plain(qc, kx, kn, tab, per_q_head=True)
    vals = codes.view(torch.float8_e4m3fn).float().reshape(4, 64)[
        tab[0].long()].reshape(-1)
    torch.cuda.synchronize()
    for w in (want[0, 0], -want[0, 1]):
        assert torch.equal(w.isnan(), vals.isnan())
        assert torch.equal(w[~vals.isnan()], vals[~vals.isnan()])
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    out["estimate"].append(dict(
        case="256 fp8 codes widened exactly (denormals, NaN)",
        max_abs_err=0.0, max_rel_err=0.0, bitwise_equal=True, ms=None,
        plain_ms=None, library_ms=None, bound_ms=None, bound_by="bytes"))
    log("estimate[physical, 256 fp8 codes]: every code read bit for bit as "
        "PyTorch's cast reads it (denormals kept, NaN codes NaN)")
    del read_timer
    return out


# ---------------------------------------------------------------------------
# Phase 3, the layer's plain-op region: the decode append and rope.
# ---------------------------------------------------------------------------

LAYER_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "fp8": torch.float8_e4m3fn}


def append_case(pool, meta, page, bpp, B, H=2, D=16, seed=0, device="cpu"):
    """A two-layer cache whose pool and metadata start random, a shuffled
    block table with rows 1 and 2 sharing their first block, and the
    lengths of each step's append: row 0 at a page's first token, then
    the next; row 1 mid-page, in the shared block's pages (bpp 64) or its
    own; row 2 past the table's last block (its block index clamps, its
    page in the block does not); row 3 inactive (scratch block 0, which
    no other row writes). One row: the first token, the next, then past
    the table. ``pool`` and ``meta`` name dtypes of
    :data:`LAYER_DTYPES`. Returns (cache, [(seq_lens, active)] a step)."""
    from quest_tpu_torch.config import ModelConfig, QuestConfig
    from quest_tpu_torch.kv.paged_kv import init_cache
    P = 8 if bpp == 1 else 2 * bpp
    quest = QuestConfig(page_size=page, max_seq_len=P * page,
                        block_pages=bpp, kv_dtype=LAYER_DTYPES[pool],
                        meta_dtype=LAYER_DTYPES[meta])
    cache = init_cache(ModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                       quest, batch_size=B, num_layers=2, device=device)
    rng = np.random.default_rng(seed)

    def rand(t):
        x = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
        return (2 * x).to(t.dtype).to(device)

    cache.kv_pages = rand(cache.kv_pages)
    hi, lo = rand(cache.k_max).float(), rand(cache.k_min).float()
    cache.k_max = torch.maximum(hi, lo).to(LAYER_DTYPES[meta])
    cache.k_min = torch.minimum(hi, lo).to(LAYER_DTYPES[meta])
    NPB, NB = cache.k_max.shape[2], cache.block_tab.shape[1]
    tab = rng.permutation(np.arange(1, NPB))[:B * NB].reshape(B, NB)
    if B > 2:
        tab[2, 0] = tab[1, 0]                       # a shared prefix block
    cache.block_tab = torch.from_numpy(tab.astype(np.int32)).to(device)
    if B == 1:
        steps = [([3 * page], None), ([3 * page + 1], [True]),
                 ([(P + 3) * page + 7], [True])]
    else:
        first = [(P // 2) * page, page + 5, (P + 3) * page + 7, 2 * page + 3]
        act = [True, True, True, False]
        steps = [(first, act), ([s + a for s, a in zip(first, act)], act)]
    return cache, [(torch.tensor(s, dtype=torch.int32, device=device),
                    None if a is None else torch.tensor(a, device=device))
                   for s, a in steps]


def append_inputs(B, H, D, inp, seed, device="cpu", large=False):
    """k, v [B, H, D] of dtype ``inp`` with an inf and a NaN lane; with
    ``large`` also values an fp8 cast saturates or not by torch version
    (470, -1000, 465) and one a bf16 cast rounds up to 3.0e38."""
    rng = np.random.default_rng(seed)
    k = 2 * rng.standard_normal((B, H, D)).astype(np.float32)
    v = 2 * rng.standard_normal((B, H, D)).astype(np.float32)
    k[0, 0, 3], k[-1, -1, 1], v[0, -1, 5] = np.inf, np.nan, -np.inf
    if large:
        k[0, -1, :4] = [470.0, -1000.0, 465.0, 3e38]
    return (torch.from_numpy(k).to(LAYER_DTYPES[inp]).to(device),
            torch.from_numpy(v).to(LAYER_DTYPES[inp]).to(device))


def fp8_code_case(meta, inp, device="cuda"):
    """An fp8 pool over 64 rows on distinct pages (half at a page's first
    token, half folding into random ``meta`` metadata) and k holding each
    of the 65536 bf16 codes once (v a permutation), as ``inp``."""
    from quest_tpu_torch.config import ModelConfig, QuestConfig
    from quest_tpu_torch.kv.paged_kv import init_cache
    B, H, D, page = 64, 8, 128, 16
    quest = QuestConfig(page_size=page, max_seq_len=4 * page, block_pages=1,
                        kv_dtype=torch.float8_e4m3fn,
                        meta_dtype=LAYER_DTYPES[meta])
    cache = init_cache(ModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                       quest, batch_size=B, num_layers=1, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    hi = torch.randn(cache.k_max.shape, generator=gen, device=device)
    lo = hi - torch.rand(hi.shape, generator=gen, device=device)
    cache.k_max = hi.to(LAYER_DTYPES[meta])
    cache.k_min = lo.to(LAYER_DTYPES[meta])
    codes = torch.arange(1 << 16, dtype=torch.int32, device=device)
    k = codes.to(torch.int16).view(torch.bfloat16).reshape(B, H, D)
    perm = torch.randperm(1 << 16, generator=gen, device=device)
    v = k.reshape(-1)[perm].reshape(B, H, D)
    cache.seq_lens = (torch.arange(B, dtype=torch.int32, device=device) % 2
                      * 5 + 2 * page)
    return cache, k.to(LAYER_DTYPES[inp]), v.to(LAYER_DTYPES[inp])


def clone_cache(cache):
    from quest_tpu_torch.kv.paged_kv import PagedKVCache
    return PagedKVCache(cache.kv_pages.clone(), cache.k_max.clone(),
                        cache.k_min.clone(), cache.block_tab.clone(),
                        cache.seq_lens.clone())


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def append_bytes(cache, k, active):
    """What one append must move: k and v read, their pool rows written,
    the lengths, table entries and mask read, and the metadata rows of
    active rows (read where the page already holds a token) written."""
    B, H, D = k.shape
    page = cache.page_size
    act = (torch.ones(B, dtype=torch.bool, device=k.device) if active is None
           else active)
    n_act = int(act.sum())
    n_fold = int((act & (cache.seq_lens % page != 0)).sum())
    meta = H * D * cache.k_max.element_size()
    return (2 * k.numel() * k.element_size()
            + 2 * B * H * D * cache.kv_pages.element_size()
            + B * 8 + (0 if active is None else B)
            + 2 * meta * (n_act + n_fold))


def timed_both(timer, read_timer, row, fns):
    """Each of ``fns`` (``ms``, ``plain_ms``, ...: callables) timed in
    turns under the memset flush (``timer``) and the read flush
    (``read_timer``): each mean into ``row`` as ``<name>`` and
    ``read_<name>``, every turn under ``turns_ms``. Returns the log's
    text, us memset / read a name."""
    from quest_tpu_torch.utils.benchmarking import in_turns
    tm = in_turns(timer, fns)
    tr = in_turns(read_timer, fns)
    row.update({k: statistics.mean(v) for k, v in tm.items()},
               **{"read_" + k: statistics.mean(v) for k, v in tr.items()},
               turns_ms={"memset": tm, "read": tr})
    return "; us, memset / read flush: " + ", ".join(
        f"{k[:-3] or 'kernel'} {row[k] * 1e3:.2f} / "
        f"{row['read_' + k] * 1e3:.2f}" for k in fns) + (
        f" (bound {row['bound_ms'] * 1e3:.3f})")


def layer_op_cases(timer, gen):
    """The two kernels of every layer's plain-op region against their
    plain versions, bit for bit. The decode append (``csrc/append.cu``
    against ``append_decode_at_plain``) at the main path's shape
    (Llama-3.1-8B's 8 KV heads, page 16, 64-page blocks, bf16 pool,
    metadata and k/v, B=2 rows at 5000 and 2500 tokens of a 16384-token
    pool), timed in turns with the plain version under the memset flush
    (``ms``) and ``Timer(flush="read")`` (``read_ms``); then every
    (pool, metadata) dtype pair at pages 16 and 32 (64-page blocks) and
    page 16 with 1-page blocks, bf16 and f32 inputs: a page's first token
    and the next, a row past the table's last block, two rows sharing a
    block, an inactive row on scratch block 0, non-finite and large
    inputs; and the fp8 pool on all 65536 bf16 codes with each metadata
    dtype. Rope (``csrc/rope.cu``, q and k in one launch, against
    ``rotate_plain`` of each): prefill chunks of the serving phase's 5120
    tokens (B=2) and of 8192 (B=1), and decode at B=2 (32 and 8 heads,
    bf16 and f32), timed the same way. The decode step's rope and
    append in one launch (``rope_append``: ``csrc/append.cu`` with its
    rotate flag, against ``rope_append_decode_at_plain``), q_rot, pool and
    metadata bit for bit: at the main path's shape, timed in turns with
    its plain version and with the two launches it replaces (``pair_ms``:
    ``rotate_qk`` then ``append_decode_at``) under both flushes; then on
    every append case above, on a cache of its own, with groups G = 4, 1
    and 8 in turn. No single PyTorch call computes any of the three
    functions, so ``library_ms`` is null."""
    from quest_tpu_torch.config import llama31_8b
    from quest_tpu_torch.kv.paged_kv import (append_decode_at,
                                             append_decode_at_plain,
                                             rope_append_decode_at,
                                             rope_append_decode_at_plain)
    from quest_tpu_torch.ops.rope import (compute_rope_params, rope_cos_sin,
                                          rotate_plain, rotate_qk)
    from quest_tpu_torch.ops.utils import fp8_cast_codes
    from quest_tpu_torch.utils.benchmarking import Timer
    out = {"append_decode": [], "rope": [], "rope_append": []}
    read_timer = Timer(flush="read")
    dev = torch.device("cuda")
    log("layer ops: no single PyTorch call computes the append (scatter, "
        "cast and metadata fold), the rope of q and k or both: library_ms "
        "is null")
    log("layer ops: the card's torch casts to e4m3 (code of 1000, of 470): "
        f"from bf16 {fp8_cast_codes(dev, torch.bfloat16)}, from f32 "
        f"{fp8_cast_codes(dev, torch.float32)}")

    def timed(row, fns, nbytes):
        return (timed_both(timer, read_timer, row, fns)
                + f", {nbytes / 1e6:.3f} MB")

    def append(label, cache, lens, k, v, active, time_it=False,
               record=True):
        cache.seq_lens = lens
        ref = clone_cache(cache)
        lay = cache.kv_pages.shape[0] - 1           # the last layer
        append_decode_at(cache, lay, k, v, active=active)
        append_decode_at_plain(ref, lay, k, v, active=active)
        torch.cuda.synchronize()
        for name in ("kv_pages", "k_max", "k_min"):
            assert same_bits(getattr(cache, name), getattr(ref, name)), \
                f"append kernel's {name} differs from the plain version " \
                f"({label})"
        nbytes = append_bytes(cache, k, active)
        row = dict(case=label, max_abs_err=0.0, max_rel_err=0.0,
                   bitwise_equal=True, ms=None, plain_ms=None,
                   library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        msg = ""
        if time_it:
            msg = timed(row, {
                "ms": lambda: append_decode_at(cache, lay, k, v, active),
                "plain_ms": lambda: append_decode_at_plain(cache, lay, k, v,
                                                           active)}, nbytes)
        if record:
            out["append_decode"].append(row)
            log(f"append_decode[{label}]: pool and metadata bitwise "
                f"equal{msg}")
        return row

    inv, ps, att = compute_rope_params(llama31_8b().rope, 128)
    inv = inv.to(dev)

    def rope_append(label, cache, lens, q, k, v, active, time_it=False,
                    record=True):
        """The merged op on ``cache`` against its plain version on a
        clone, bit for bit; with ``time_it`` timed in turns with the
        plain version and with the rope and append it replaces."""
        cache.seq_lens = lens
        ref = clone_cache(cache)
        lay = cache.kv_pages.shape[0] - 1
        cos, sin = rope_cos_sin(lens[:, None], inv, ps, att)
        got = rope_append_decode_at(cache, lay, q, k, v, cos, sin, active)
        want = rope_append_decode_at_plain(ref, lay, q, k, v, cos, sin,
                                           active)
        torch.cuda.synchronize()
        assert same_bits(got, want), f"rope_append's q differs ({label})"
        for name in ("kv_pages", "k_max", "k_min"):
            assert same_bits(getattr(cache, name), getattr(ref, name)), \
                f"rope_append's {name} differs from the plain version " \
                f"({label})"
        nbytes = (append_bytes(cache, k, active)
                  + 2 * q.numel() * q.element_size() + 2 * cos.numel() * 4)
        row = dict(case=label, max_abs_err=0.0, max_rel_err=0.0,
                   bitwise_equal=True, ms=None, plain_ms=None,
                   library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        msg = ""
        if time_it:
            cs, sn = cos[:, 0], sin[:, 0]                 # [B, 1, 64]

            def pair():
                _, ko = rotate_qk(q, k, cs, sn)
                append_decode_at(cache, lay, ko, v, active)
            msg = timed(row, {
                "ms": lambda: rope_append_decode_at(cache, lay, q, k, v, cos,
                                                    sin, active),
                "plain_ms": lambda: rope_append_decode_at_plain(
                    cache, lay, q, k, v, cos, sin, active),
                "pair_ms": pair}, nbytes)
        if record:
            out["rope_append"].append(row)
            log(f"rope_append[{label}]: q_rot, pool and metadata bitwise "
                f"equal{msg}")
        return row

    # The main path's shape: phase 6's B=2 rows in its 16384-token pool.
    cfg, _, cache = make_pool(16384, 2, gen)
    H, D = cfg.num_kv_heads, cfg.head_dim
    k = torch.randn((2, H, D), generator=gen, device="cuda").bfloat16()
    v = torch.randn((2, H, D), generator=gen, device="cuda").bfloat16()
    lens = torch.tensor([5000, 2500], dtype=torch.int32, device="cuda")
    act = torch.ones(2, dtype=torch.bool, device="cuda")
    append("main path: bf16, page 16, B=2 at 5000 and 2500 tokens", cache,
           lens, k, v, act, time_it=True)
    q = torch.randn((2, cfg.num_heads, D), generator=gen,
                    device="cuda").bfloat16()
    rope_append("main path: bf16, page 16, B=2, 32/8 heads at 5000 and 2500 "
                "tokens", cache, lens, q, k, v, act, time_it=True)
    del cache
    # Every dtype pair: one row a pair, over all its geometries and steps.
    geoms = ((16, 64, 4), (32, 64, 4), (16, 1, 4), (16, 64, 1))
    # The merged op takes the same cases on a clone of each cache, with
    # G = 4, 1, 8 query heads a KV head in turn.
    for pool in LAYER_DTYPES:
        for meta in LAYER_DTYPES:
            n, first, first_m, groups = 0, None, None, set()
            for page, bpp, B in geoms:
                for inp in ("bf16", "f32"):
                    if inp == "f32" and (page, bpp, B) != geoms[0]:
                        continue
                    c, steps = append_case(pool, meta, page, bpp, B, H=H,
                                           D=D, seed=page + bpp, device=dev)
                    cm = clone_cache(c)
                    for i, (lens, act) in enumerate(steps):
                        k, v = append_inputs(B, H, D, inp, seed=i,
                                             device=dev, large=True)
                        label = (f"{pool} pool, {meta} metadata, {inp} k/v, "
                                 f"page {page}, {bpp}-page blocks, B={B}, "
                                 f"step {i}")
                        row = append(label, c, lens, k, v, act, record=False)
                        G = (4, 1, 8)[n % 3]
                        q = torch.randn((B, H * G, D), generator=gen,
                                        device=dev).to(LAYER_DTYPES[inp])
                        row_m = rope_append(f"{label}, G={G}", cm, lens, q,
                                            k, v, act, record=False)
                        first, first_m = first or row, first_m or row_m
                        n += 1
                        groups.add(G)
                    del c, cm
            cases = ("(pages 16 and 32, 64- and 1-page blocks, B=4 and 1, "
                     "bf16 and f32 k/v; first tokens, a clamped block, a "
                     "shared block, scratch)")
            first["case"] = (f"{pool} pool, {meta} metadata: {n} appends "
                             + cases)
            first_m["case"] = (f"{pool} pool, {meta} metadata: {n} rope "
                               f"appends, G in {sorted(groups)} " + cases)
            out["append_decode"].append(first)
            out["rope_append"].append(first_m)
            log(f"append_decode[{first['case']}]: pool and metadata bitwise "
                f"equal in every one")
            log(f"rope_append[{first_m['case']}]: q_rot, pool and metadata "
                f"bitwise equal in every one")
    for meta, inp in (("f32", "bf16"), ("bf16", "bf16"), ("fp8", "bf16"),
                      ("fp8", "f32")):
        c, k, v = fp8_code_case(meta, inp)
        cm = clone_cache(c)
        append(f"fp8 pool on all 65536 bf16 codes, {meta} metadata, {inp} "
               f"k/v", c, c.seq_lens, k, v, None)
        q = torch.randn((k.shape[0], 4 * k.shape[1], D), generator=gen,
                        device=dev).to(LAYER_DTYPES[inp])
        rope_append(f"fp8 pool, k on all 65536 bf16 codes before the rope, "
                    f"{meta} metadata, {inp} q/k/v, G=4", cm, cm.seq_lens, q,
                    k, v, None)
        del c, cm

    def rope(label, B, T, Hq, Hkv, dtype, pos0, time_it=False):
        q = torch.randn((B, T, Hq, D), generator=gen, device="cuda").to(dtype)
        kk = torch.randn((B, T, Hkv, D), generator=gen,
                         device="cuda").to(dtype)
        inv, ps, att = compute_rope_params(cfg.rope, D)
        pos = (torch.tensor(pos0, device="cuda")[:, None]
               + torch.arange(T, device="cuda")).int()
        cs = rope_cos_sin(pos, inv, ps, att)
        qo, ko = rotate_qk(q, kk, *cs)
        wq, wk = rotate_plain(q, *cs), rotate_plain(kk, *cs)
        torch.cuda.synchronize()
        assert same_bits(qo, wq) and same_bits(ko, wk), \
            f"rope kernel differs from the plain version ({label})"
        nbytes = (2 * (q.numel() + kk.numel()) * q.element_size()
                  + 2 * cs[0].numel() * 4)
        row = dict(case=label, max_abs_err=0.0, max_rel_err=0.0,
                   bitwise_equal=True, ms=None, plain_ms=None,
                   library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        msg = ""
        if time_it:
            msg = timed(row, {
                "ms": lambda: rotate_qk(q, kk, *cs),
                "plain_ms": lambda: (rotate_plain(q, *cs),
                                     rotate_plain(kk, *cs))}, nbytes)
        out["rope"].append(row)
        log(f"rope[{label}]: q and k bitwise equal{msg}")

    # The main path's first (the kernel list's row): since the decode rope
    # moved into rope_append, rope runs at prefill chunks only.
    bf16 = torch.bfloat16
    rope("serving prefill, bf16, B=2, T=5120, 32/8 heads", 2, 5120, 32, 8,
         bf16, [0, 0], time_it=True)
    rope("prefill chunk, bf16, B=1, T=8192, 32/8 heads", 1, 8192, 32, 8,
         bf16, [0], time_it=True)
    rope("decode, bf16, B=2, 32/8 heads at 5000 and 2500", 2, 1, 32, 8, bf16,
         [5000, 2500], time_it=True)
    rope("decode, f32, B=2, 32/8 heads", 2, 1, 32, 8, torch.float32,
         [5000, 2500])
    rope("prefill, f32, B=2, T=2048 at 30000, 32/8 heads", 2, 2048, 32, 8,
         torch.float32, [30000, 7])
    rope("decode, bf16, B=4, 8/8 heads", 4, 1, 8, 8, bf16, [0, 1, 16, 131071])
    del read_timer
    return out


def ulp_distance(a, b):
    """Units in the last place between a and b (one dtype, bf16 or f32),
    by their bit patterns mapped to a monotone integer line."""
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    top = 1 << (15 if a.dtype == torch.bfloat16 else 31)

    def line(t):
        i = t.contiguous().view(bits).to(torch.int64)
        return torch.where(i < 0, -top - i, i)
    return (line(a) - line(b)).abs()


NORM_VAR_ULPS = 4                     # note d: the variance, f32 ulps
HEAD_TOL = 1e-5                       # head_gemv vs the f32 product
HEAD_ROWS = (2, 1, 4, 16)             # the main path's M = 2 first


def norm_head_cases(timer, gen):
    """The two kernels that replace XLA fusions of the JAX model's norm
    and head. ``rms_norm`` (``csrc/rms_norm.cu``) against
    ``rms_norm_plain`` at Llama-3.1-8B's width 4096: a decode step's B=2
    rows, a prefill chunk of 8192 tokens (B=1) and the serving phase's
    B=2 x 5120, each with the residual folded in and without, in bf16 and
    f32, and a width of 4100 (the element-at-a-time route): ``h`` bit
    for bit, each row's variance (the kernel's ``var_out``) within
    NORM_VAR_ULPS f32 ulps of the plain version's and, given the kernel's
    variance, the norm ``rms_scale_plain``'s bit for bit (note d); the
    share of outputs that differ from the plain version and by how many
    ulps printed. The bf16 rows with the residual are timed under the memset
    and the read flush beside the plain version and
    ``torch.nn.functional.rms_norm`` of h (the norm alone: no PyTorch
    call adds the residual). ``head_gemv`` (``csrc/head_gemv.cu``) at M =
    2, 1, 4 and 16 rows over the 4096 x 128256 bf16 head, the tp = 2
    shard's 64128 columns and an odd vocabulary (128257), within
    HEAD_TOL of the f32 product, timed under both flushes beside its
    plain version (``x @ w.float()``), the f32 ``torch.matmul`` over an
    f32 copy of the head (the port's route before: ``library_ms``) and
    the bf16 ``torch.matmul`` of the same shape."""
    from quest_tpu_torch.ops.decode_common import sm_count
    from quest_tpu_torch.ops.head_gemv import (head_gemv, head_gemv_plain,
                                               head_gemv_plan)
    from quest_tpu_torch.ops.rms_norm import (rms_norm, rms_norm_plain,
                                              rms_scale_plain)
    from quest_tpu_torch.utils.benchmarking import Timer
    out = {"rms_norm": [], "head_gemv": []}
    read_timer = Timer(flush="read")
    eps = 1e-5

    def timed(row, fns):
        return timed_both(timer, read_timer, row, fns)

    def norm(label, shape, dtype, residual, time_it=False):
        H = shape[-1]
        rows = math.prod(shape[:-1])
        x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        r = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        w = (1 + 0.5 * torch.randn((H,), generator=gen, device="cuda")
             ).to(dtype)
        var = torch.empty(rows, device="cuda")
        if residual:
            h, got = rms_norm(x, w, eps, residual=r, var_out=var)
            want_h, want = rms_norm_plain(x, w, eps, residual=r)
            assert same_bits(h, want_h), f"rms_norm's h differs ({label})"
        else:
            got = rms_norm(x, w, eps, var_out=var)
            want_h, want = x, rms_norm_plain(x, w, eps)
        torch.cuda.synchronize()
        hf = want_h.float().reshape(rows, H)
        var_ulps = int(ulp_distance(var, (hf * hf).mean(dim=-1)).max())
        given = same_bits(got, rms_scale_plain(
            want_h, var.reshape(shape[:-1]), w, eps))
        d = ulp_distance(got, want)
        esz = x.element_size()
        nbytes = (4 if residual else 2) * rows * H * esz + H * esz
        row = dict(case=label, max_abs_err=float(
                       (got.float() - want.float()).abs().max()),
                   max_rel_err=rel_err(got, want), h_bitwise=residual,
                   var_max_ulps=var_ulps, bitwise_given_var=given,
                   out_max_ulps=int(d.max()),
                   out_share_differing=float((d > 0).float().mean()),
                   bitwise_equal=bool((d == 0).all()), ms=None,
                   plain_ms=None, library_ms=None,
                   bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes")
        msg = ""
        if time_it:
            args = (x, w, eps) + ((r,) if residual else ())
            msg = timed(row, {
                "ms": lambda: rms_norm(*args),
                "plain_ms": lambda: rms_norm_plain(*args),
                "library_ms": lambda: torch.nn.functional.rms_norm(
                    want_h, (H,), w, eps)})
        out["rms_norm"].append(row)
        log(f"rms_norm[{label}]: h bit for bit {residual}; variance within "
            f"{var_ulps} f32 ulps (limit {NORM_VAR_ULPS}); given it, the "
            f"norm bit for bit {given}; "
            f"{100 * row['out_share_differing']:.4f}% of outputs differ from "
            f"the plain version, by at most {row['out_max_ulps']} ulp{msg}")
        assert var_ulps <= NORM_VAR_ULPS, f"rms_norm variance ({label})"
        assert given, f"rms_norm differs given its variance ({label})"

    bf16, f32 = torch.bfloat16, torch.float32
    log("rms_norm: library_ms is torch.nn.functional.rms_norm of h (the "
        "norm alone; no PyTorch call adds the residual)")
    norm("decode, bf16, B=2, 4096, residual", (2, 1, 4096), bf16, True,
         time_it=True)
    norm("decode, bf16, B=2, 4096, no residual", (2, 1, 4096), bf16, False)
    norm("decode, f32, B=2, 4096, residual", (2, 1, 4096), f32, True)
    norm("decode, f32, B=2, 4096, no residual", (2, 1, 4096), f32, False)
    norm("prefill chunk, bf16, T=8192, 4096, residual", (1, 8192, 4096),
         bf16, True, time_it=True)
    norm("prefill chunk, bf16, T=8192, 4096, no residual", (1, 8192, 4096),
         bf16, False)
    norm("serving prefill, bf16, B=2 T=5120, 4096, residual",
         (2, 5120, 4096), bf16, True, time_it=True)
    norm("serving prefill, f32, B=2 T=5120, 4096, residual",
         (2, 5120, 4096), f32, True)
    norm("serving prefill, f32, B=2 T=5120, 4096, no residual",
         (2, 5120, 4096), f32, False)
    norm("width 4100, bf16, 33 rows, residual", (33, 4100), bf16, True)
    norm("width 4100, f32, 33 rows, no residual", (33, 4100), f32, False)

    K, V = 4096, 128256
    w = (torch.randn((K, V + 1), generator=gen, device="cuda")
         / math.sqrt(K)).to(bf16)
    sms = sm_count(torch.device("cuda"))
    for label, N, rows_list in (("Llama-3.1-8B head", V, HEAD_ROWS),
                                ("tp = 2 shard", V // 2, (2,)),
                                ("odd vocabulary", V + 1, (2,))):
        wn = w[:, :N].contiguous() if N != V + 1 else w
        w32 = wn.float()
        for M in rows_list:
            x = torch.randn((M, K), generator=gen, device="cuda")
            got = head_gemv(x, wn)
            want = x @ w32
            torch.cuda.synchronize()
            err = rel_err(got, want)
            nbytes = K * N * 2 + M * (K + N) * 4
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = 2 * M * K * N / F32_FLOPS * 1e3
            plan = head_gemv_plan(K, N, sms, M)
            row = dict(case=f"{label}, {K}x{N}, M={M}",
                       max_abs_err=float((got - want).abs().max()),
                       max_rel_err=err, plan=plan._asdict(),
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            xb = x.to(bf16)
            msg = timed(row, {
                "ms": lambda: head_gemv(x, wn),
                "plain_ms": lambda: head_gemv_plain(x, wn),
                "library_ms": lambda: x @ w32,
                "bf16_matmul_ms": lambda: xb @ wn})
            out["head_gemv"].append(row)
            log(f"head_gemv[{row['case']}]: rel err {err:.2e} (limit "
                f"{HEAD_TOL}); plan {tuple(plan)}{msg}; library: the f32 "
                f"matmul over an f32 head")
            assert err <= HEAD_TOL, f"head_gemv disagrees ({row['case']})"
        del w32, wn
        torch.cuda.empty_cache()
    del w, read_timer
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 3, the prefill append and the MLP's SiLU product.
# ---------------------------------------------------------------------------

def append_prefill_case(pool, meta, page, bpp, B=4, H=2, D=16, seed=0,
                        device="cpu"):
    """A two-layer cache of P = max(8, 2 bpp) pages a row whose pool and
    metadata start random, a shuffled block table (each row its own
    blocks), and three chunks as (seq_lens, new_lens, T): T = 2 page + 4
    with a row of new_lens T from 0, one inside a page with fewer, an
    empty row and a row at the pool's end (p0 = P - W, the write start
    clamped before its offset); T = (P - 1) page + 3, so W = P, the
    start clamped in three rows; T = 5 across a page edge, one token at
    a page's start (its page's only valid slot), clamped at the pool's
    end, and an empty row. ``B`` rows (at most 4) take the first B of
    each. Returns (cache, steps)."""
    from quest_tpu_torch.config import ModelConfig, QuestConfig
    from quest_tpu_torch.kv.paged_kv import init_cache
    P = max(8, 2 * bpp)
    quest = QuestConfig(page_size=page, max_seq_len=P * page,
                        block_pages=bpp, kv_dtype=LAYER_DTYPES[pool],
                        meta_dtype=LAYER_DTYPES[meta])
    cache = init_cache(ModelConfig(num_kv_heads=H, num_heads=H, head_dim=D),
                       quest, batch_size=B, num_layers=2, device=device)
    rng = np.random.default_rng(seed)

    def rand(t):
        x = torch.from_numpy(rng.standard_normal(t.shape).astype(np.float32))
        return (2 * x).to(t.dtype).to(device)

    cache.kv_pages = rand(cache.kv_pages)
    hi, lo = rand(cache.k_max).float(), rand(cache.k_min).float()
    cache.k_max = torch.maximum(hi, lo).to(LAYER_DTYPES[meta])
    cache.k_min = torch.minimum(hi, lo).to(LAYER_DTYPES[meta])
    NPB, NB = cache.k_max.shape[2], cache.block_tab.shape[1]
    tab = rng.permutation(np.arange(1, NPB))[:B * NB].reshape(B, NB)
    cache.block_tab = torch.from_numpy(tab.astype(np.int32)).to(device)
    end = P * page
    T0, T1 = 2 * page + 4, (P - 1) * page + 3
    steps = [([0, page + 5, 2 * page + 3, end - page + 4],
              [T0, T0 - 3, 0, page - 4], T0),
             ([5, 0, page - 1, 2 * page], [T1, T1 // 2, T1, 7], T1),
             ([page - 2, 2 * page, end - 2, 3], [5, 1, 2, 0], 5)]
    return cache, [(torch.tensor(o[:B], dtype=torch.int32, device=device),
                    torch.tensor(n[:B], dtype=torch.int32, device=device), T)
                   for o, n, T in steps]


def prefill_inputs(B, T, H, D, inp, seed, device="cpu", large=False,
                   low=False):
    """k, v [B, T, H, D] of dtype ``inp`` with inf and NaN lanes; with
    ``large`` also, in one token, values an fp8 cast saturates or not by
    torch version (470, -1000, 465, 3e38); with ``low`` a key of
    -3.3e38 (a bf16 value) at row 1's first token: where it is its
    page's only valid slot (the T = 5 chunk of
    :func:`append_prefill_case`), the max folds it with the invalid
    slots' -3.0e38 and -3.0e38 wins."""
    rng = np.random.default_rng(seed)
    k = 2 * rng.standard_normal((B, T, H, D)).astype(np.float32)
    v = 2 * rng.standard_normal((B, T, H, D)).astype(np.float32)
    k[0, min(1, T - 1), 0, 3], v[0, min(2, T - 1), -1, 5] = np.inf, np.nan
    k[-1, -1, -1, 1] = np.nan
    if large:
        k[0, 0, -1, :4] = [470.0, -1000.0, 465.0, 3e38]
    if low:
        k[min(1, B - 1), 0, 0, 6] = -3.3e38
    return (torch.from_numpy(k).to(LAYER_DTYPES[inp]).to(device),
            torch.from_numpy(v).to(LAYER_DTYPES[inp]).to(device))


def same_outside_scratch(a, b):
    """Pool and metadata bit for bit outside physical block 0 (scratch)."""
    bpp = a.block_pages
    return (same_bits(a.kv_pages[:, :, bpp:], b.kv_pages[:, :, bpp:])
            and same_bits(a.k_max[:, :, 1:], b.k_max[:, :, 1:])
            and same_bits(a.k_min[:, :, 1:], b.k_min[:, :, 1:]))


def prefill_append_bytes(cache, k, new_lens):
    """What one prefill append of ``k`` [B, T, Hkv, D] into ``cache`` at
    its lengths must move for this run's rows
    (``scripts/bench_kernels.py:append_prefill_bytes``)."""
    from quest_tpu_torch.scripts.bench_kernels import append_prefill_bytes
    B, T, H, D = k.shape
    return append_prefill_bytes(
        cache.seq_lens.tolist(), new_lens.tolist(), T, H, D, cache.page_size,
        cache.max_pages, k.element_size(), cache.kv_pages.element_size(),
        cache.k_max.element_size())


SILU_ULPS = 1                     # silu_mul vs plain: expf may differ


def prefill_mlp_cases(timer, gen):
    """The prefill append (``csrc/append.cu``'s prefill route against
    ``append_prefill_at_plain``) and the MLP's SiLU product
    (``csrc/silu_mul.cu`` against ``silu_mul_plain``). The append at full
    width (8 KV heads, head dim 128, bf16 k/v, pool and metadata, page
    16, 64-page blocks, a shuffled table): the T=8192 chunk of one row
    (profile_textgen's ctx 8192) and the serving phase's B=2, T=5120
    chunk of rows of 5000 and 2500, each timed in turns with its plain
    version under the memset and the read flush; then every (pool,
    metadata) dtype pair on the chunks of :func:`append_prefill_case` at
    pages 16 and 32 with 64-page blocks and page 16 with 1-page blocks,
    bf16 and f32 k/v, non-finite and large inputs (e4m3 codes past 448,
    a page whose only valid key is below -3.0e38): pool (padding tokens
    included) and metadata (of untouched pages too) bit for bit outside
    scratch block 0. The SiLU
    product at the decode step's [2, 14336] and the T=8192 chunk's
    [8192, 14336], bf16 and f32, timed the same way, then an odd length
    with special values and an unaligned view (the scalar path): bit for
    bit or within SILU_ULPS, the differing share printed. No single
    PyTorch call computes either function: ``library_ms`` is null."""
    from quest_tpu_torch.kv.paged_kv import (append_prefill_at,
                                             append_prefill_at_plain)
    from quest_tpu_torch.ops.silu_mul import silu_mul, silu_mul_plain
    from quest_tpu_torch.utils.benchmarking import Timer
    out = {"append_prefill": [], "silu_mul": []}
    read_timer = Timer(flush="read")
    dev = torch.device("cuda")
    log("prefill append and silu_mul: no single PyTorch call computes "
        "either function: library_ms is null")

    def append(label, cache, lens, new_lens, k, v, time_it=False,
               record=True):
        cache.seq_lens = lens
        ref = clone_cache(cache)
        lay = cache.kv_pages.shape[0] - 1           # the last layer
        before = append_prefill_at.launches
        append_prefill_at(cache, lay, k, v, new_lens=new_lens)
        assert append_prefill_at.launches == before + 1
        append_prefill_at_plain(ref, lay, k, v, new_lens=new_lens)
        torch.cuda.synchronize()
        assert same_outside_scratch(cache, ref), \
            f"prefill append differs from the plain version ({label})"
        nbytes = prefill_append_bytes(cache, k, new_lens)
        row = dict(case=label, max_abs_err=0.0, max_rel_err=0.0,
                   bitwise_equal=True, ms=None, plain_ms=None,
                   library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        msg = ""
        if time_it:
            msg = timed_both(timer, read_timer, row, {
                "ms": lambda: append_prefill_at(cache, lay, k, v, new_lens),
                "plain_ms": lambda: append_prefill_at_plain(
                    cache, lay, k, v, new_lens)}) + (
                f", {nbytes / 1e6:.3f} MB")
        if record:
            out["append_prefill"].append(row)
            log(f"append_prefill[{label}]: pool and metadata bitwise equal "
                f"outside scratch{msg}")
        return row

    # The main path's shapes: a T=8192 chunk (B=1), the serving chunk.
    for B, T, n in ((1, 8192, [8192]), (2, 5120, [5000, 2500])):
        _, _, cache = make_pool(16384, B, gen)
        H, D = cache.kv_pages.shape[1], cache.kv_pages.shape[-1]
        k = torch.randn((B, T, H, D), generator=gen, device=dev).bfloat16()
        v = torch.randn((B, T, H, D), generator=gen, device=dev).bfloat16()
        zeros = torch.zeros(B, dtype=torch.int32, device=dev)
        append(f"prefill chunk: bf16, page 16, B={B}, T={T}, rows of {n} "
               f"tokens from 0", cache, zeros,
               torch.tensor(n, dtype=torch.int32, device=dev), k, v,
               time_it=True)
        del cache, k, v
    torch.cuda.empty_cache()
    H, D = 8, 128
    geoms = ((16, 64), (32, 64), (16, 1))
    for pool in LAYER_DTYPES:
        for meta in LAYER_DTYPES:
            n, first = 0, None
            for page, bpp in geoms:
                for inp in ("bf16", "f32"):
                    if inp == "f32" and (page, bpp) != geoms[0]:
                        continue
                    c, steps = append_prefill_case(pool, meta, page, bpp,
                                                   H=H, D=D, seed=page + bpp,
                                                   device=dev)
                    for i, (lens, nl, T) in enumerate(steps):
                        k, v = prefill_inputs(4, T, H, D, inp, seed=i,
                                              device=dev, large=True,
                                              low=True)
                        row = append(f"{pool} pool, {meta} metadata, {inp} "
                                     f"k/v, page {page}, {bpp}-page blocks, "
                                     f"T={T}", c, lens, nl, k, v,
                                     record=False)
                        first = first or row
                        n += 1
                    del c
            first["case"] = (f"{pool} pool, {meta} metadata: {n} chunks "
                             "(pages 16 and 32, 64- and 1-page blocks, bf16 "
                             "and f32 k/v; empty, short and full rows, W = "
                             "P, clamped at the pool's end, large and "
                             "non-finite inputs)")
            out["append_prefill"].append(first)
            log(f"append_prefill[{first['case']}]: pool and metadata "
                f"bitwise equal outside scratch in every one")

    def silu(label, shape, dtype, time_it=False, special=False, shift=0):
        n = math.prod(shape)
        flat = torch.randn(2 * n, generator=gen, device=dev) * 4
        if special:
            flat[:6] = torch.tensor([float("inf"), -float("inf"),
                                     float("nan"), -100.0, 100.0, -0.0])
        # With ``shift`` the operands start ``shift`` elements past an
        # allocation (not 16-byte aligned: the kernel's scalar path).
        gs = torch.empty(n + shift, dtype=dtype, device=dev)
        us = torch.empty(n + shift, dtype=dtype, device=dev)
        gs[shift:], us[shift:] = flat[:n], flat[n:]
        g, u = gs[shift:].view(shape), us[shift:].view(shape)
        before = silu_mul.launches
        got = silu_mul(g, u)
        assert silu_mul.launches == before + 1
        want = silu_mul_plain(g, u)
        torch.cuda.synchronize()
        fin, inf = torch.isfinite(want), torch.isinf(want)
        assert torch.equal(torch.isnan(got), torch.isnan(want)) and (
            torch.equal(got[inf], want[inf])), \
            f"silu_mul's NaN and inf differ from the plain version ({label})"
        ulps = ulp_distance(got[fin], want[fin])
        differ, worst = int((ulps > 0).sum()), int(ulps.max())
        assert worst <= SILU_ULPS, \
            f"silu_mul {worst} ulps from the plain version ({label})"
        nbytes = 3 * n * g.element_size()
        row = dict(case=label,
                   max_abs_err=float((got[fin].float()
                                      - want[fin].float()).abs().max()),
                   max_rel_err=rel_err(got[fin], want[fin]),
                   bitwise_equal=differ == 0, ulps_max=worst,
                   differing_share=differ / n, ms=None, plain_ms=None,
                   library_ms=None, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                   bound_by="bytes")
        msg = ""
        if time_it:
            msg = timed_both(timer, read_timer, row, {
                "ms": lambda: silu_mul(g, u),
                "plain_ms": lambda: silu_mul_plain(g, u)}) + (
                f", {nbytes / 1e6:.3f} MB")
        out["silu_mul"].append(row)
        log(f"silu_mul[{label}]: {differ} of {n} elements differ from the "
            f"plain version ({100 * differ / n:.4f}%), at most {worst} "
            f"ulp{msg}")

    bf16 = torch.bfloat16
    silu("decode step, bf16 [2, 14336]", (2, 1, 14336), bf16, time_it=True)
    silu("prefill chunk, bf16 [8192, 14336]", (1, 8192, 14336), bf16,
         time_it=True)
    silu("decode step, f32 [2, 14336]", (2, 1, 14336), torch.float32,
         time_it=True)
    silu("prefill chunk, f32 [8192, 14336]", (1, 8192, 14336),
         torch.float32, time_it=True)
    for dtype in (bf16, torch.float32):
        name = str(dtype).split(".")[-1]
        silu(f"odd length with inf, NaN, +-100 and -0, {name} [3, 1000003]",
             (3, 1000003), dtype, special=True)
        silu(f"unaligned view (scalar path), {name} [5, 14336]", (5, 14336),
             dtype, shift=1)
    del read_timer
    torch.cuda.empty_cache()
    return out


def fp8_cases(timer, gen):
    """The fp8 e4m3 branches of the four attention kernels at the
    serving configuration's shapes (Llama-3.1-8B attention, B=2, 32768 +
    7001 tokens in a 32768-token pool, shuffled block table, bf16 query,
    fp8 pool and fp8 metadata), once at page 16 and once at page 32. Each
    is held against its plain version and timed beside its bound (the
    KV bytes at one byte an element), its plain version, its bf16 branch
    over the same values (the pool read through upcast_fp8) and the
    library call over those bf16 values."""
    from quest_tpu_torch.ops.dense_decode import (
        dense_decode_attention, dense_decode_attention_plain)
    from quest_tpu_torch.ops.estimate import (page_scores_kernel,
                                              page_scores_kernel_plain,
                                              page_scores_physical)
    from quest_tpu_torch.ops.sparse_decode import (
        sparse_decode_attention, sparse_decode_attention_plain)
    from quest_tpu_torch.ops.topk import select_pages
    from quest_tpu_torch.ops.utils import upcast_fp8
    fp8 = torch.float8_e4m3fn
    out = {k: [] for k in ("sparse_decode", "dense_decode", "prefill",
                           "estimate")}

    def record(kname, label, got, want, tol, ms, plain, bf16_ms, lib,
               nbytes, flops=0):
        err = rel_err(got, want)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        by = "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S \
            else "bytes"
        out[kname].append(dict(
            case=label, max_abs_err=float((got - want).abs().max()),
            max_rel_err=err, ms=ms, plain_ms=plain, bf16_ms=bf16_ms,
            library_ms=lib, bound_ms=bound, bound_by=by))
        log(f"{kname}[{label}]: rel err {err:.2e}, {ms * 1e3:.1f} us (bound "
            f"{bound * 1e3:.1f} us, plain {plain * 1e3:.1f} us, bf16 branch "
            f"{bf16_ms * 1e3:.1f} us, library {lib * 1e3:.1f} us)")
        assert err <= tol, f"{kname} fp8 branch disagrees ({label}): {err}"

    for page in (16, 32):
        cfg, quest, cache = make_pool(32768, 2, gen, page_size=page,
                                      kv_dtype=fp8)
        B, Hq, Hkv, D = 2, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        G, P, agg = Hq // Hkv, cache.max_pages, quest.group_agg
        seq = torch.tensor([32768, 7001], dtype=torch.int32, device="cuda")
        q = torch.randn((B, Hq, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        pool16 = upcast_fp8(cache.kv_pages)           # the same values
        kw = dict(sm_scale=1.0 / math.sqrt(D), layer=0,
                  block_tab=cache.block_tab, block_pages=cache.block_pages)
        tag = f"fp8 page {page}"

        # Sparse: the serving path's selection over the fp8 metadata.
        scores = page_scores_physical(q, cache.k_max[0], cache.k_min[0],
                                      cache.block_tab, group_agg=agg)
        idx, nv = select_pages(scores, seq, page, quest.page_budget)
        args = (idx, nv, seq)
        got = sparse_decode_attention(q, cache.kv_pages, *args, **kw)
        want = sparse_decode_attention_plain(q, cache.kv_pages, *args, **kw)
        torch.cuda.synchronize()
        n_pages = int(nv.sum()) * Hkv
        record("sparse_decode", tag, got, want, REL_TOL,
               timer(lambda: sparse_decode_attention(q, cache.kv_pages, *args,
                                                     **kw)),
               timer(lambda: sparse_decode_attention_plain(
                   q, cache.kv_pages, *args, **kw)),
               timer(lambda: sparse_decode_attention(q, pool16, *args, **kw)),
               timer(sparse_sdpa(cache, q, idx, nv, seq, kv_pages=pool16)),
               n_pages * 2 * page * D + idx.numel() * 4 + q.numel() * 6)

        # Dense over every token of both rows.
        got = dense_decode_attention(q, cache.kv_pages, seq, **kw)
        want = dense_decode_attention_plain(q, cache.kv_pages, seq, **kw)
        torch.cuda.synchronize()
        n_max = int(seq.max())
        kv = [gather_tokens(cache, b, n_max, kv_pages=pool16)
              for b in range(B)]
        K, V = torch.stack([k for k, _ in kv]), torch.stack([v for _, v in kv])
        mask = (torch.arange(n_max, device="cuda")[None, :]
                < seq[:, None])[:, None, None, :]
        qs = (q.float() / math.sqrt(D)).to(torch.bfloat16)[:, :, None]
        record("dense_decode", tag, got, want, REL_TOL,
               timer(lambda: dense_decode_attention(q, cache.kv_pages, seq,
                                                    **kw)),
               timer(lambda: dense_decode_attention_plain(q, cache.kv_pages,
                                                          seq, **kw)),
               timer(lambda: dense_decode_attention(q, pool16, seq, **kw)),
               timer(lambda: sdpa(qs, K, V, attn_mask=mask, scale=1.0)),
               int(seq.sum()) * Hkv * 2 * D + q.numel() * 6
               + cache.block_tab.numel() * 4)
        del K, V, kv

        # Prefill: a 2048-token chunk of row 0, fresh and after 4096 cached
        # tokens.
        T = 2048
        kwp = dict(kw, block_tab=cache.block_tab[:1])
        for offset in (0, 4096):
            qp = torch.randn((1, T, Hq, D), generator=gen,
                             device="cuda").to(torch.bfloat16)
            off = torch.tensor([offset], dtype=torch.int32, device="cuda")
            K, V = gather_tokens(cache, 0, offset + T, kv_pages=pool16)
            qps = (qp.float() / math.sqrt(D)).to(torch.bfloat16).transpose(
                1, 2)
            lib = prefill_sdpa(qps, K[None], V[None], offset)
            out["prefill"].append(prefill_case(
                timer, f"{tag}, T=2048 offset={offset}", qp, cache.kv_pages,
                off, off + T, kwp, 4 * Hq * D * causal_pairs(T, offset,
                                                             offset + T),
                (offset + T) * Hkv * 2 * D + qp.numel() * 6, lib,
                bf16_pool=pool16))
        del K, V, pool16

        # Streaming estimate over each row's logical fp8 metadata.
        phys = (cache.block_tab.long()[:, :, None] * cache.block_pages
                + torch.arange(cache.block_pages, device="cuda")).reshape(B, P)
        km = cache.k_max[0].reshape(Hkv, -1, D)[:, phys].transpose(
            0, 1).contiguous()
        kn = cache.k_min[0].reshape(Hkv, -1, D)[:, phys].transpose(
            0, 1).contiguous()
        km16, kn16 = upcast_fp8(km), upcast_fp8(kn)
        got = page_scores_kernel(q, km, kn, agg)
        want = page_scores_kernel_plain(q, km, kn, agg)
        torch.cuda.synchronize()
        qc = torch.cat([q.float().clamp(min=0), q.float().clamp(max=0)],
                       dim=-1).to(torch.bfloat16).reshape(B * Hkv, G, 2 * D)
        mc = torch.cat([km16, kn16], dim=-1).reshape(B * Hkv, P, 2 * D
                                                     ).transpose(1, 2
                                                                 ).contiguous()
        record("estimate", tag, got, want, 1e-5,
               timer(lambda: page_scores_kernel(q, km, kn, agg)),
               timer(lambda: page_scores_kernel_plain(q, km, kn, agg)),
               timer(lambda: page_scores_kernel(q, km16, kn16, agg)),
               timer(lambda: torch.bmm(qc, mc)),
               2 * km.numel() + q.numel() * 2 + B * Hkv * P * 4,
               2 * 2 * B * Hq * P * D)
        del cache, km, kn, km16, kn16, mc
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 4: the probe path (the copy probe and the select pieces).
# ---------------------------------------------------------------------------

GROUPS = (4, 3, 6, 16, 32)      # 4: the preset's group, in the same turn


def group_cases(timer, gen):
    """Every GQA group the kernels pad (3 and 6: to 4 and 8 heads a CTA),
    a whole 16-head CTA and two sub-groups of 16 (32), beside the
    preset's 4 in the same turn: the sparse, dense, estimate, fused and
    prefill kernels at the main path's shapes with 8 KV heads and 8 G
    query heads (B=2, 32768 + 7001 tokens, page 16; prefill T=2048 at
    offset 0, bf16 and fp8 pools), each held to its plain version within
    2e-2 (the estimate 1e-5, the fused ids with no flip outside the 1e-5
    band) and timed beside its bound; then ``qgemv`` (M = 2) and
    ``dequant`` over a 4096 x 1000 weight, int8 and int4, whose rows are
    not 16-byte multiples. Returns each kernel's cases."""
    from quest_tpu_torch.models.quantize import quantize_weight
    from quest_tpu_torch.ops.dense_decode import (
        dense_decode_attention, dense_decode_attention_plain)
    from quest_tpu_torch.ops.estimate import (page_scores_kernel,
                                              page_scores_kernel_plain,
                                              page_scores_physical)
    from quest_tpu_torch.ops.fused_decode import (fused_sparse_decode,
                                                  fused_sparse_decode_plain,
                                                  slot_page_scores)
    from quest_tpu_torch.ops.prefill import (prefill_attention,
                                             prefill_attention_plain)
    from quest_tpu_torch.ops.qdot import (dequant, dequant_plain, qgemv,
                                          qgemv_plain)
    from quest_tpu_torch.ops.reference import selection_flips
    from quest_tpu_torch.ops.sparse_decode import (
        sparse_decode_attention, sparse_decode_attention_plain)
    from quest_tpu_torch.ops.topk import select_pages
    out = {k: [] for k in ("sparse_decode", "dense_decode", "estimate",
                           "fused_decode", "prefill", "qgemv", "dequant")}

    def record(kname, label, got, want, ms, nbytes, flops=0, tol=REL_TOL,
               plain_ms=None, library_ms=None, **extra):
        err = rel_err(got, want)
        bound = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
        by = "operations" if flops / BF16_FLOPS > nbytes / HBM_BYTES_PER_S \
            else "bytes"
        out[kname].append(dict(
            case=label, max_abs_err=float((got.float() - want.float()).abs()
                                          .max()),
            max_rel_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound, bound_by=by, **extra))
        log(f"{kname}[{label}]: rel err {err:.2e}, {ms * 1e3:.1f} us "
            f"(bound {bound * 1e3:.1f} us"
            + (f", plain {plain_ms * 1e3:.1f} us" if plain_ms else "")
            + (f", bf16 matmul {library_ms * 1e3:.1f} us" if library_ms
               else "") + ")" + "".join(
                f", {k} {v}" for k, v in extra.items()))
        assert err <= tol, f"{kname} disagrees ({label}): {err}"

    cfg, quest, cache = make_pool(32768, 2, gen)
    fp8_pool = cache.kv_pages.to(torch.float8_e4m3fn)
    seq = torch.tensor([32768, 7001], dtype=torch.int32, device="cuda")
    B, Hkv, D, page = 2, cfg.num_kv_heads, cfg.head_dim, quest.page_size
    S, agg, P = quest.page_budget, quest.group_agg, cache.max_pages
    n = (seq.long() + page - 1) // page
    npr = n.repeat_interleave(Hkv)
    kw = dict(sm_scale=1.0 / math.sqrt(D), layer=0,
              block_tab=cache.block_tab, block_pages=cache.block_pages)
    phys = (cache.block_tab.long()[:, :, None] * cache.block_pages
            + torch.arange(cache.block_pages, device="cuda")).reshape(B, P)
    km = cache.k_max[0].reshape(Hkv, -1, D)[:, phys].transpose(0, 1).contiguous()
    kn = cache.k_min[0].reshape(Hkv, -1, D)[:, phys].transpose(0, 1).contiguous()
    for G in GROUPS:
        Hq = Hkv * G
        tag = f"G={G} ({Hq}/{Hkv} heads)"
        q = torch.randn((B, Hq, D), generator=gen,
                        device="cuda").to(torch.bfloat16)
        qbytes = q.numel() * (2 + 4)
        scores = page_scores_physical(q, cache.k_max[0], cache.k_min[0],
                                      cache.block_tab, group_agg=agg)
        idx, nv = select_pages(scores, seq, page, S)
        got = sparse_decode_attention(q, cache.kv_pages, idx, nv, seq, **kw)
        want = sparse_decode_attention_plain(q, cache.kv_pages, idx, nv, seq,
                                             **kw)
        torch.cuda.synchronize()
        record("sparse_decode", tag, got, want, timer(
            lambda: sparse_decode_attention(q, cache.kv_pages, idx, nv, seq,
                                            **kw)),
               int(nv.sum()) * Hkv * 2 * page * D * 2 + idx.numel() * 4
               + qbytes)
        got = dense_decode_attention(q, cache.kv_pages, seq, **kw)
        want = dense_decode_attention_plain(q, cache.kv_pages, seq, **kw)
        torch.cuda.synchronize()
        record("dense_decode", tag, got, want, timer(
            lambda: dense_decode_attention(q, cache.kv_pages, seq, **kw)),
               int(seq.sum()) * Hkv * 2 * D * 2 + qbytes
               + cache.block_tab.numel() * 4)
        got = page_scores_kernel(q, km, kn, agg)
        want = page_scores_kernel_plain(q, km, kn, agg)
        torch.cuda.synchronize()
        record("estimate", tag, got, want, timer(
            lambda: page_scores_kernel(q, km, kn, agg)),
               2 * km.numel() * 2 + q.numel() * 2 + B * Hkv * P * 4,
               flops=2 * 2 * B * Hq * P * D, tol=1e-5)
        fkw = dict(kw, budget_pages=S, group_agg=agg)
        args = (cache.kv_pages, cache.k_max, cache.k_min, seq)
        got, ids = fused_sparse_decode(q, *args, return_ids=True, **fkw)
        want, want_ids = fused_sparse_decode_plain(q, *args, return_ids=True,
                                                   **fkw)
        plain_scores = slot_page_scores(q, cache.k_max, cache.k_min,
                                        layer=0, block_tab=cache.block_tab,
                                        block_pages=cache.block_pages,
                                        group_agg=agg)
        flips, gap = selection_flips(ids.reshape(B * Hkv, S),
                                     want_ids.reshape(B * Hkv, S),
                                     plain_scores.reshape(B * Hkv, P), npr)
        assert flips == 0 or gap <= 1e-5, f"fused {tag}: {flips} ids, {gap}"
        record("fused_decode", tag, got, want, timer(
            lambda: fused_sparse_decode(q, *args, **fkw)),
               Hkv * int(n.sum()) * 2 * D * 2
               + Hkv * int(n.clamp(max=S).sum()) * 2 * page * D * 2
               + q.numel() * 2 + B * Hq * D * 4, flipped_ids=flips)
        # Prefill: one row, 2048 fresh tokens, bf16 then fp8 pool.
        T = 2048
        qp = torch.randn((1, T, Hq, D), generator=gen,
                         device="cuda").to(torch.bfloat16)
        off = torch.zeros(1, dtype=torch.int32, device="cuda")
        pkw = dict(kw, block_tab=cache.block_tab[:1])
        flops = 4 * Hq * D * causal_pairs(T, 0, T)
        for pool, pname, esz in ((cache.kv_pages, "bf16", 2),
                                 (fp8_pool, "fp8", 1)):
            got = prefill_attention(qp, pool, off, off + T, **pkw)
            want = prefill_attention_plain(qp, pool, off, off + T, **pkw)
            torch.cuda.synchronize()
            record("prefill", f"{tag}, {pname}, T=2048 offset 0", got, want,
                   timer(lambda: prefill_attention(qp, pool, off, off + T,
                                                   **pkw)),
                   T * Hkv * 2 * D * esz + qp.numel() * (2 + 4), flops=flops)
        del qp, got, want
    del cache, fp8_pool, km, kn
    # The weight kernels at an out width of 1000 (bf16 x, M = 2).
    K, N, M = 4096, 1000, 2
    w = (torch.randn((K, N), generator=gen, device="cuda")
         / math.sqrt(K)).to(torch.bfloat16)
    x = torch.randn((M, K), generator=gen, device="cuda").to(torch.bfloat16)
    for bits in (8, 4):
        qw = quantize_weight(w, bits)
        tag = f"{K}x{N} int{bits}"
        got = qgemv(x, qw.q, qw.s, None, bits)
        want = qgemv_plain(x, qw.q, qw.s, None, bits, torch.bfloat16)
        torch.cuda.synchronize()
        record("qgemv", f"{tag}, M={M}", got, want,
               timer(lambda: qgemv(x, qw.q, qw.s, None, bits)),
               K * N * bits // 8 + 4 * N + M * (K + N) * 2,
               flops=2 * M * K * N,
               plain_ms=timer(lambda: qgemv_plain(x, qw.q, qw.s, None, bits,
                                                  torch.bfloat16)),
               library_ms=timer(lambda: x @ w))
        got = dequant(qw.q, qw.s, None, bits, torch.bfloat16)
        want = dequant_plain(qw.q, qw.s, None, bits, torch.bfloat16)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"dequant {tag} is not bitwise"
        record("dequant", f"{tag}, bf16, bitwise", got, want,
               timer(lambda: dequant(qw.q, qw.s, None, bits,
                                     torch.bfloat16)),
               K * N * bits // 8 + 4 * N + K * N * 2, tol=0.0,
               plain_ms=timer(lambda: dequant_plain(qw.q, qw.s, None, bits,
                                                    torch.bfloat16)))
    return out


COPY_PAGES_KB = (8, 16, 32)    # one bf16 K+V page at page 16, 32, 64
COPY_TOTAL_MB = 256            # five times the 50 MB L2
SELECT_SG = 16                 # one [16, 128] band a (row, KV head) of
                               # a 2048-page row at B=2, 8 KV heads


def probe_phase(timer):
    """The probe entry points on the card. The copy probe
    (quest_tpu_torch.exp.gather_ab / dma_probe) over 256 MB: contig and
    gather at pages of 8, 16 and 32 KB, each against its plain version,
    then timed in turns over three rounds, and a gather_hi run on a
    high-priority stream; a reading above the card's 3.35 TB/s fails the
    phase (copies were dropped). The seven select pieces
    (quest_tpu_torch.exp.select_compile2) at SG=16. Returns each kernel's
    cases, the launches of each kernel's probe run, and the GB/s
    table."""
    from quest_tpu_torch.exp import dma_probe, gather_ab, select_compile2
    from quest_tpu_torch.ops.copy_probe import (copy_probe, copy_probe_plain,
                                                stage_plan)
    from quest_tpu_torch.ops.select_pieces import (STAGES, select_pieces,
                                                   select_pieces_plain)
    nslot, rounds = 3, 3
    runs = gather_ab.build_runs(COPY_TOTAL_MB, COPY_PAGES_KB, "cuda",
                                modes=("gather", "contig"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for pk in COPY_PAGES_KB:
        page_bytes, ppc = pk << 10, gather_ab.CHUNK_KB // pk
        plan = stage_plan((COPY_TOTAL_MB << 20) // page_bytes, page_bytes,
                          ppc, nslot, 1, sms)
        log(f"copy_probe[{pk} KB pages]: {plan.describe(page_bytes, ppc)}")
    errs = gather_ab.check(runs, nslot)
    log(f"copy_probe vs plain, max rel err {max(errs.values()):.2e} over "
        f"{len(errs)} runs")
    assert max(errs.values()) <= 1e-5, f"copy probe disagrees: {errs}"

    copy_probe.launches = 0
    times = gather_ab.measure(runs, nslot, rounds, timer, log=log)
    hi = dma_probe.probe("gather_hi", gather_ab.CHUNK_KB, nslot,
                         COPY_TOTAL_MB, 1, 16, timer=timer)
    copy_launches = copy_probe.launches
    log(f"dma_probe: {hi['label']} {hi['us']:.1f} us {hi['gbps']:.0f} GB/s")
    assert hi["ok"], "gather_hi output disagrees with the formula"
    gbps = {f"{m} {pk}KB": [COPY_TOTAL_MB * 2**20 / (t * 1e-3) / 1e9
                            for t in ts] for (m, pk), ts in times.items()}
    gbps["gather_hi 16KB"] = [hi["gbps"]]
    top = max(max(v) for v in gbps.values())
    assert top <= HBM_BYTES_PER_S / 1e9, (
        f"a copy-probe reading of {top:.0f} GB/s exceeds the card's "
        f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s: copies were dropped")

    copy_cases = []
    for run in runs:
        q = torch.zeros((8, 128), dtype=torch.float32, device="cuda")
        key = (run.mode, run.page_kb)
        nbytes = run.xp.numel() * 2 + run.idx.numel() * 4 + 2 * q.numel() * 4
        got, want = run(q, nslot), copy_probe_plain(run.idx, q, run.xp,
                                                    run.ppc)
        copy_cases.append(dict(
            case=f"{run.mode} {run.page_kb} KB pages, {COPY_TOTAL_MB} MB",
            max_abs_err=float((got - want).abs().max()),
            max_rel_err=errs[key], ms=statistics.median(times[key]),
            plain_ms=timer(lambda: copy_probe_plain(run.idx, q, run.xp,
                                                    run.ppc)),
            # Yardstick: the same pages read in the same order by one
            # gather, which also writes them back out.
            library_ms=timer(lambda: torch.index_select(run.xp, 0,
                                                        run.idx.long())),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            gbps=gbps[f"{run.mode} {run.page_kb}KB"]))
    # The head case: the page-32 gather (16 KB pages).
    copy_cases.sort(key=lambda c: c["case"] != f"gather 16 KB pages, "
                                               f"{COPY_TOTAL_MB} MB")

    # Select pieces: each stage against its plain version, then the
    # script's own run of every stage (which launches and checks it).
    sel_cases = []
    for stage in STAGES:
        s = torch.from_numpy(select_compile2.make_input(stage, SELECT_SG)
                             ).cuda()
        got, want = select_pieces(s, stage), select_pieces_plain(s, stage)
        torch.cuda.synchronize()
        bad = select_compile2.mismatch(got, want, stage)
        assert bad == 0, f"select piece {stage} disagrees: {bad}"
        flat = s.view(SELECT_SG, -1)
        sel_cases.append(dict(
            case=f"{stage}, SG={SELECT_SG}",
            max_abs_err=float((got - want).abs().max()),
            max_rel_err=rel_err(got, want) if stage in
            select_compile2.SUM_STAGES else 0.0,
            ms=timer(lambda: select_pieces(s, stage)),
            plain_ms=timer(lambda: select_pieces_plain(s, stage)),
            library_ms=timer(lambda: torch.cumsum(flat, dim=1))
            if stage == "cumsum" else None,
            bound_ms=2 * s.numel() * 4 / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes"))
    sel_cases.sort(key=lambda c: not c["case"].startswith("cumsum"))
    select_pieces.launches = 0
    for stage in STAGES:
        assert select_compile2.main([stage, str(SELECT_SG)]) == 0, stage
    sel_launches = select_pieces.launches
    log(f"select_pieces: 7 stages match their plain versions; "
        + ", ".join(f"{c['case'].split(',')[0]} {c['ms'] * 1e3:.1f} us"
                    for c in sel_cases))
    for name, n in (("copy_probe", copy_launches),
                    ("select_pieces", sel_launches)):
        assert n > 0, f"the probe path launched no {name} kernel"
    return ({"copy_probe": copy_cases, "select_pieces": sel_cases},
            {"copy_probe": copy_launches, "select_pieces": sel_launches},
            gbps)


# ---------------------------------------------------------------------------
# Phase 5: the slice against its plain CPU path on a small model.
# ---------------------------------------------------------------------------

# Prompts of the 4-layer phases. Near-tied page scores make the greedy
# tokens follow rounding: over prompt seeds 5-16, the plain prefill on the
# card gave the CPU's bf16 tokens at every step for 6 of 12 seeds, and at
# seed 5 it failed three of the six phases itself (PERF.md). Seed 7
# passes every phase with the plain prefill and with the kernel, so a
# failure here is the kernels' and not the inputs'.
PROMPT_SEED = 7


def small_reference_phase(dtype, tol=None, steps=8, fused=False,
                          serving_kv=None, bits=None):
    """A 4-layer model with GQA group 4 and head dim 128, its weights
    and KV pool in ``dtype``, served on the card and on the CPU's plain
    path from the same weights and prompts, both fed the CPU's greedy
    tokens. The greedy tokens must agree at every step; the logits must
    agree within ``tol`` where one is given. In bf16 none is: the CPU's
    and cuBLAS's bf16 matrix products round differently, and over four
    layers that alone moves the logits by more than the kernels' own
    2e-2 (held in phase 3). Every forward launches 2L + 1 norms and, over
    a plain bf16 head, one ``head_gemv``. With ``fused`` the sparse
    layers take the fused kernel: the pool grows to 2048 tokens (128
    pages, where the model's gate opens), and the card's fused launches
    must be 2 a step. With ``serving_kv`` (a KV dtype) the engines run the serving
    configuration instead: page 32, fp8 e4m3 metadata, a 4-page budget,
    that KV dtype. With ``bits`` (8 or 4) the weights are quantized (RTN)
    first and the card's weight kernels' launches must be the path's: a
    prefill's layer linears dequantize, its lm_head and every decode
    step's products take qgemv."""
    from quest_tpu_torch.config import (QuestConfig, serving_quest_config,
                                        small_tpu_model)
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.models.llama import init_params
    from quest_tpu_torch.models.quantize import quantize_params
    from quest_tpu_torch.ops.fused_decode import fused_sparse_decode
    from quest_tpu_torch.ops.head_gemv import head_gemv
    from quest_tpu_torch.ops.qdot import dequant, qgemv
    from quest_tpu_torch.kv.paged_kv import append_prefill_at
    from quest_tpu_torch.ops.rms_norm import rms_norm
    from quest_tpu_torch.ops.silu_mul import silu_mul
    cfg = dataclasses.replace(small_tpu_model(), num_layers=4, num_heads=8,
                              num_kv_heads=2, dtype=dtype)
    if serving_kv is not None:
        quest = serving_quest_config(1024, token_budget=128,
                                     kv_dtype=serving_kv)
    else:
        quest = QuestConfig(page_size=16, token_budget=64,
                            max_seq_len=2048 if fused else 1024,
                            kv_dtype=dtype, fused_decode=fused)
    params = init_params(cfg, torch.Generator().manual_seed(5),
                         device="cpu")
    if bits:
        params = quantize_params(params, bits)
    rng = np.random.default_rng(PROMPT_SEED)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (300, 170)]
    gpu = QuestEngine(cfg, quest, params, batch_size=2, device="cuda")
    cpu = QuestEngine(cfg, quest, params, batch_size=2, device="cpu")
    fused_sparse_decode.launches = qgemv.launches = dequant.launches = 0
    rms_norm.launches = head_gemv.launches = 0
    silu_mul.launches = append_prefill_at.launches = 0
    g, c = gpu.prefill(prompts), cpu.prefill(prompts)
    errs, same = [], []
    assert all(-(-len(p) // quest.page_size) > quest.page_budget
               for p in prompts), "the sparse path is not live"
    for step in range(steps + 1):
        assert np.isfinite(g).all(), "non-finite logits on the card"
        errs.append(rel_err(torch.from_numpy(g), torch.from_numpy(c)))
        tok = np.argmax(c, axis=-1)
        same.append(bool((np.argmax(g, axis=-1) == tok).all()))
        if step < steps:
            g, c = gpu.decode(tok), cpu.decode(tok)
    torch.cuda.synchronize()
    launches = fused_sparse_decode.launches
    weight_launches = dict(qgemv=qgemv.launches, dequant=dequant.launches)
    norm_head = dict(rms_norm=rms_norm.launches, head_gemv=head_gemv.launches,
                     silu_mul=silu_mul.launches,
                     append_prefill=append_prefill_at.launches)
    name = str(dtype).split(".")[-1] + ("/fused" if fused else "") + (
        f"/serving {str(serving_kv).split('.')[-1]} KV" if serving_kv
        else "") + (f"/int{bits} weights" if bits else "")
    log(f"reference[{name}]: 4-layer model on the card vs the plain CPU "
        f"path over prefill + {steps} sparse decode steps: greedy tokens "
        f"agree at {sum(same)} of {len(same)} steps, max logits rel err "
        f"{max(errs):.2e} (limit {tol if tol else 'none'}; per step "
        f"{' '.join(f'{e:.1e}' for e in errs)}); fused launches {launches}"
        + (f", weight kernels {weight_launches}" if bits else ""))
    want = steps * (cfg.num_layers - quest.skip_layers) if fused else 0
    assert launches == want, f"fused launches {launches} != path {want}"
    want = (quant_launches(cfg, steps, 1) if bits
            else dict(qgemv=0, dequant=0))
    assert weight_launches == want, (
        f"weight kernel launches {weight_launches} != path {want}")
    # A forward (the one-chunk prefill, each decode step) runs 2L + 1
    # norms, L SiLU products, and one head_gemv where the head is plain
    # bf16; the prefill one append a layer.
    want = dict(rms_norm=(2 * cfg.num_layers + 1) * (steps + 1),
                head_gemv=(steps + 1) if dtype == torch.bfloat16
                and not bits else 0,
                silu_mul=cfg.num_layers * (steps + 1),
                append_prefill=cfg.num_layers)
    assert norm_head == want, (f"norm / head / SiLU / prefill append "
                               f"launches {norm_head} != {want}")
    assert all(same), f"greedy tokens differ from the CPU path ({name})"
    assert tol is None or max(errs) <= tol, (
        f"card path disagrees with the CPU path: {max(errs)}")
    return max(errs)


# ---------------------------------------------------------------------------
# Phase 6: full-width Llama-3.1-8B served end to end.
# ---------------------------------------------------------------------------

def cache_bytes(cache):
    return sum(t.numel() * t.element_size()
               for t in (cache.kv_pages, cache.k_max, cache.k_min))


# Engine name: its QuestConfig (max_seq_len 16384) by keyword arguments.
SERVING_PATHS = ("unfused", "fused", "serving", "serving_fp8")
# Device ops (kernels, copies, memsets) of one decode step in the profile:
# the sparse and dense kernels merge their splits in the same launch, one
# launch a layer (30 sparse + 2 dense layers unfused, 2 dense fused); a
# sparse layer's selection is two launches unfused (the estimate's
# physical route and the select), none fused (inside its one kernel).
# The rope and the append are one launch together a layer (rope_append:
# the rope's 18 plain ops a layer and the append's 44, 46 over an fp8
# pool, before their kernels, then one launch each), and the
# `new_lens > 0` mask is made once a step. The 2L + 1 = 65 norms are one
# launch each, the 64 residual adds folded into them, and the head one
# head_gemv launch. So 687 - 32 = 655 unfused and serving (bf16 and fp8
# KV), 627 - 32 = 595 fused; the MLP's SiLU and its product one launch
# a layer (silu_mul) where they were two: 623 and 563. The int8 and int4
# engines' step (QUANT_OPS_PER_STEP) runs one qgemv a linear, 7 a layer
# and the head's, where the bf16 step runs 7 cuBLAS products and 3
# split-K reductions a layer and one head_gemv: 623 - 321 + 225 = 527
# (559 before silu_mul, 591 before the rope went into the append's
# launch). Each count is of ops launched
# (profile_steps): the profiler can lose a launched op's device record.
DEVICE_OPS_PER_STEP = {"unfused": 623, "fused": 563, "serving": 623,
                       "serving_fp8": 623}
QUANT_OPS_PER_STEP = 527
# The kernels a sparse layer launches on the unfused decode step, one
# each.
SPARSE_LAYER_KERNELS = ("estimate", "topk_select", "sparse_decode")


def layer_launches(L, forwards, decode_steps, heads=None):
    """The launches of the kernels every layer of every path runs: the
    2L + 1 norms and L SiLU products once a forward (a prefill chunk or a
    decode step), rope and the prefill append once a prefill chunk, the
    rope and append together (rope_append) once a decode step; and
    ``head_gemv``, once a forward of a plain bf16 head over at most 16
    rows (``heads``, default ``forwards``; 0 for a quantized head). The
    standalone decode append launches on no path."""
    return {"rope": L * (forwards - decode_steps),
            "append_prefill": L * (forwards - decode_steps),
            "rope_append": L * decode_steps,
            "rms_norm": (2 * L + 1) * forwards,
            "silu_mul": L * forwards,
            "head_gemv": forwards if heads is None else heads}
# Idle seconds between a profiled window's edges and the steps inside it.
PROFILE_MARGIN_S = 0.25


def serving_quest(path):
    from quest_tpu_torch.config import QuestConfig, serving_quest_config
    if path.startswith("serving"):
        kv = torch.float8_e4m3fn if path == "serving_fp8" else torch.bfloat16
        return serving_quest_config(16384, kv_dtype=kv)
    return QuestConfig(max_seq_len=16384, fused_decode=path == "fused")


def serving_phase(kernels, smi):
    """Four engines over one set of random weights: the unfused pipeline
    (``QuestConfig`` default), ``fused_decode=True``, and the serving
    configuration (``serving_quest_config``: page 32, fp8 e4m3 metadata)
    with a bf16 and with an fp8 e4m3 KV pool. Each serves ``generate``
    and ``generate_ondevice``, the kernel launches of every run checked
    against its path; then the decode steps are timed in turns (each
    path, then each again in reverse order) and two steps of each are
    profiled. ``kernels``: each kernel's wrapper by name. Returns the
    launch counts, the numbers and the weights (for the scheduler
    phase)."""
    from quest_tpu_torch.config import llama31_8b
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.models.llama import init_params

    cfg = llama31_8b()
    t0 = time.time()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    engines = {path: QuestEngine(cfg, serving_quest(path), params,
                                 batch_size=2, device="cuda")
               for path in SERVING_PATHS}
    torch.cuda.synchronize()
    pools = {path: cache_bytes(e.cache) for path, e in engines.items()}
    log(f"serving: Llama-3.1-8B, {cfg.num_layers} layers, random bf16 "
        f"weights shared by {len(engines)} engines, set up in "
        f"{time.time() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated; pool + "
        f"metadata bytes: " + ", ".join(
            f"{p} {pools[p] / 2**30:.3f} GiB (page "
            f"{engines[p].quest.page_size}, KV "
            f"{str(engines[p].quest.kv_dtype).split('.')[-1]}, metadata "
            f"{str(engines[p].quest.resolved_meta_dtype).split('.')[-1]})"
            for p in SERVING_PATHS))
    rng = np.random.default_rng(0)
    L, skip, N = cfg.num_layers, engines["unfused"].quest.skip_layers, 32
    counts, outs, totals = {}, {}, {}

    def run(path, label, fn, prompts):
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t = time.time()
        out = fn(prompts, max_new_tokens=N)
        torch.cuda.synchronize()
        dt = time.time() - t
        got = {n: k.launches for n, k in kernels.items()}
        chunks = -(-max(map(len, prompts)) // engines[path].prefill_chunk)
        sparse = (L - skip) * (N - 1)
        want = dict.fromkeys(kernels, 0)
        want.update(prefill=L * chunks, dense_decode=skip * (N - 1),
                    **layer_launches(L, chunks + N - 1, N - 1))
        want.update(dict.fromkeys(("fused_decode",) if path == "fused"
                                  else SPARSE_LAYER_KERNELS, sparse))
        log(f"serving[{path}, {label}]: prompts {[len(p) for p in prompts]}, "
            f"{N} tokens each in {dt:.2f} s; launches {got}")
        assert got == want, f"launch counts {got} != path {want}"
        assert all(len(r) == N and all(0 <= t < cfg.vocab_size for t in r)
                   for r in out), "tokens out of range"
        counts[(path, label)], outs[(path, label)] = got, out
        return dt

    p1 = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (6000, 3000)]
    p2 = [rng.integers(1, cfg.vocab_size, size=n).tolist() for n in (5000, 2500)]
    # Both rows of both pairs hold more pages than every engine's budget
    # (128 pages of 16 tokens, 64 of 32).
    assert all(min(map(len, p1 + p2)) > e.quest.page_budget
               * e.quest.page_size for e in engines.values())
    for path, engine in engines.items():
        run(path, "generate", engine.generate, p1)
        engine.clear()
        totals[path] = run(path, "generate_ondevice", engine.generate_ondevice,
                           p2)
    same = [np.mean(np.array(outs[("unfused", lb)]) == np.array(
        outs[("fused", lb)])) for lb in ("generate", "generate_ondevice")]
    log(f"serving: fused and unfused greedy tokens agree at "
        f"{100 * same[0]:.1f}% / {100 * same[1]:.1f}% of positions "
        f"(generate / generate_ondevice; random bf16 weights)")

    # Prefill of the second pair in turns, each followed by one step.
    prefill_s = {}
    for path in SERVING_PATHS + SERVING_PATHS[::-1]:
        engine = engines[path]
        engine.clear()
        torch.cuda.synchronize()
        t = time.time()
        logits = engine.prefill(p2)
        prefill_s.setdefault(path, []).append(time.time() - t)
        assert np.isfinite(logits).all(), "non-finite prefill logits"
        logits = engine.decode(np.argmax(logits, axis=-1))
        assert np.isfinite(logits).all(), "non-finite decode logits"
    # Phase 16 on these engines: captured against eager, decode steps
    # timed in turns and profiled both ways.
    graphs = graph_engine_phase(engines, p2, kernels, smi)
    n_prompt = sum(map(len, p2))
    serving = {}
    for path in SERVING_PATHS:
        tps = [n_prompt / t for t in prefill_s[path]]
        g = graphs[path]
        log(f"serving[{path}]: prefill {n_prompt} tokens at "
            f"{' / '.join(f'{x:.0f}' for x in tps)} tokens/s; decode "
            f"{' / '.join(f'{x:.2f}' for x in g['wall_ms_per_step']['eager'])}"
            f" ms/step eager, "
            f"{' / '.join(f'{x:.2f}' for x in g['wall_ms_per_step']['graph'])}"
            f" captured, at B=2 (generate_ondevice total "
            f"{totals[path]:.2f} s)")
        serving[path] = dict(pool_bytes=pools[path],
                             prefill_tokens_per_s=tps,
                             generate_ondevice_s=totals[path], graphs=g)
        # The ops the two profiled eager steps launched (a launch counts
        # though the profiler lost its device op's record), with half an
        # op a step of slack for one op more or less over the two.
        ops = g["eager_launched_ops_per_step"]
        assert abs(ops - DEVICE_OPS_PER_STEP[path]) <= 0.5, (
            f"{path}: {ops} device ops launched a decode step, expected "
            f"{DEVICE_OPS_PER_STEP[path]} (device op after its launch by "
            f"{g['profile_eager']['launch_lag_ms']:.3f} ms at least)")
    serving["token_agreement"] = same
    return counts, serving, params


def profile_decode(engine, tok, label, steps=2, graph=False):
    """Where a decode step's time goes: :func:`profile_steps` over
    ``steps`` on-device greedy steps of ``engine``: the model's step
    (eager), or with ``graph`` the engine's compiled step (replays)."""
    step = engine._tok_fn if graph else engine.model.decode_token_step

    def run():
        nonlocal tok
        for _ in range(steps):
            tok = step(engine.cache, tok)
        return steps
    return profile_steps(run, label)


def profile_steps(run, label):
    """torch.profiler over ``run()``, which returns the decode steps it
    ran. Prints device time by kernel and the device's busy share of the
    wall time; the trace goes to
    build/chip_smoke/decode_trace_<label>.json, each device op's count and
    time to decode_ops_<label>.json. The profiler runs a warm-up cycle
    (one small op) before the traced one: kernels launched just as a
    trace starts can be missing from it, which read as 1-10 ops fewer a
    step. The profiler also keeps only the device ops whose times, on
    its clock, fall inside the traced window, and the device's clock may
    read some milliseconds off the host's: on one card it read 173 ops
    fewer over two eager steps. So the window opens PROFILE_MARGIN_S
    before the first step and closes as long after the last, and the
    trace's device-vs-host lag and its host launches without a device op
    are printed (:func:`trace_launches`)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    trace = OUT_DIR / f"decode_trace_{label}.json"
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(
                     str(trace))) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(PROFILE_MARGIN_S)
        t = time.time()
        steps = run()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t) * 1e3
        time.sleep(PROFILE_MARGIN_S)
        prof.step()
    # The model's trace ranges come back as device events too
    # (gpu_user_annotation); device_ops leaves them out.
    from quest_tpu_torch.scripts.profile_textgen import device_ops
    events = device_ops(prof.key_averages())
    events.sort(key=lambda e: -e.self_device_time_total)
    (OUT_DIR / f"decode_ops_{label}.json").write_text(json.dumps(
        [(e.key, e.count, e.self_device_time_total) for e in events]))
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    n_launch = sum(e.count for e in events)
    lag, launched, unseen, issued = trace_launches(trace)
    log(f"profile[{label}]: {steps} decode steps, wall {wall_ms:.1f} ms, device busy "
        f"{device_ms:.1f} ms ({100 * device_ms / wall_ms:.1f}%), "
        f"{n_launch / steps:.1f} device ops a step in the profile, "
        f"{issued / steps:.1f} launched ({launched} host launches in the "
        f"trace, {len(unseen)} with no device op: "
        f"{sorted(set(unseen))[:6]}); device op after its "
        f"launch by {lag:.3f} ms at least; top device time:")
    top = []
    for e in events[:12]:
        top.append(dict(name=e.key[:80], count=e.count,
                        device_ms=e.self_device_time_total / 1e3))
        log(f"  {e.self_device_time_total / 1e3 / steps:8.3f} ms/step  "
            f"x{e.count // steps:5d}  {e.key[:90]}")
    return dict(profile_wall_ms_per_step=wall_ms / steps,
                profile_device_ms_per_step=device_ms / steps,
                device_ops_per_step=n_launch / steps, profile_top=top,
                launched_ops_per_step=issued / steps, launch_lag_ms=lag,
                host_launches=launched, launches_without_device_op=unseen)


# Host calls that put one op (or, for a graph, its ops) on the device.
LAUNCH_CALLS = ("LaunchKernel", "Memcpy", "Memset", "GraphLaunch")


def trace_launches(trace):
    """Over the Chrome trace at ``trace``: the least time, on the
    profiler's clock, from a host launch (``cuda_runtime`` or
    ``cuda_driver`` event) to the start of the device op it launched (a
    device op cannot start before its launch, so a negative lag is the
    device clock reading behind the host's by at least that much); the
    number of host calls that launch device work (LAUNCH_CALLS); the
    names of those whose device op is not in the trace; and the ops
    launched, each counted once whether its host call, its device op or
    both are in the trace. Over eager steps, where each call launches one
    op, that last is the ops the steps put on the device: the profiler
    can drop a device op's record (a step's first op, on the quantized
    engines, in 1-3 of 1118) though its launch is in the trace."""
    events = json.loads(Path(trace).read_text())["traceEvents"]
    host, device = {}, {}
    for e in events:
        corr = e.get("args", {}).get("correlation")
        if corr is None or "ts" not in e:
            continue
        cat = e.get("cat", "")
        if cat in ("cuda_runtime", "cuda_driver"):
            if any(c in e.get("name", "") for c in LAUNCH_CALLS):
                host[corr] = (float(e["ts"]), e["name"])
        elif cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.setdefault(corr, float(e["ts"]))
    lags = [ts - host[c][0] for c, ts in device.items() if c in host]
    lag = min(lags) / 1e3 if lags else float("nan")
    unseen = [name for c, (_, name) in host.items() if c not in device]
    return lag, len(host), unseen, len(host.keys() | device.keys())


# ---------------------------------------------------------------------------
# Phases 7-8: the continuous-batching scheduler.
# ---------------------------------------------------------------------------

def scheduler_requests(vocab, bt, eos_token_id=None, seed=3):
    """The 4-layer scheduler phase's requests, in units of ``bt`` tokens
    (one allocation block), for the settings of :func:`scheduler_kwargs`
    (3 slots, 6 usable blocks): more requests than slots, staggered
    prompts; uid 0 spans three blocks and its prompt (2.5 blocks) is
    longer than a prefill chunk; uid 1 samples (temperature 0.8); uid 2
    stops at ``eos_token_id``; uid 3 shares uid 0's first two blocks;
    uid 4 needs four blocks and waits for them. Also the CPU tests'
    request set (tests/test_torch_serving.py)."""
    from quest_tpu_torch.engine.scheduler import Request
    rng = np.random.default_rng(seed)

    def prompt(n):
        return rng.integers(1, vocab, size=n).tolist()

    p0 = prompt(2 * bt + bt // 2 + 3)
    return [Request(0, p0, 12),
            Request(1, prompt(bt // 2 + 5), 10, temperature=0.8),
            Request(2, prompt(bt + 7), 8, eos_token_id=eos_token_id),
            Request(3, p0[:2 * bt] + prompt(bt // 4), 8),
            Request(4, prompt(3 * bt + 1), 6),
            Request(5, prompt(bt // 4), 5)]


def scheduler_kwargs(quest):
    """The scheduler settings of :func:`scheduler_requests`: 3 slots,
    bursts of 4, chunks of one block, 6 usable blocks."""
    bt = quest.block_pages * quest.page_size
    return dict(max_batch=3, burst=4, prefill_chunk=bt,
                prefill_bucket=bt // 4, total_pages=6 * quest.block_pages)


def drive_lockstep(engines, requests):
    """Submit ``requests`` to every engine and step them together; the
    tick kinds must agree at every step. Returns (generations by uid of
    each engine, the tick sequence)."""
    import copy
    gens = [{r.uid: [] for r in requests} for _ in engines]
    for e in engines:
        for r in requests:
            e.submit(copy.deepcopy(r))
    ticks = []
    while engines[0].has_work():
        for e, g in zip(engines, gens):
            for ev in e.step():
                g[ev.uid].append(ev.token)
        kinds = {e.last_tick for e in engines}
        assert len(kinds) == 1, f"tick {len(ticks)}: kinds differ: {kinds}"
        ticks.append(engines[0].last_tick)
    assert not any(e.has_work() for e in engines), "engines drained unevenly"
    return gens, ticks


class KernelTap:
    """Copies the operands and the result of chosen attention-kernel
    calls that the model makes, by standing in for the kernels' names in
    ``quest_tpu_torch.models.llama``, then holds each result against the
    kernel's plain version on the copied operands. The kernel runs once,
    as the path runs it, so the launch counts stay the path's; only the
    pool's layer that the call reads is copied. ``want(kernel, layer)``
    names the call's batch (a label) or returns None; the first call of
    each (kernel, label) is taken, of calls on ``device`` only. A replayed
    graph never calls the Python names, so the compiled steps run under
    ``engine.graphs.eager()`` while the tap is open."""

    NAMES = {"prefill": "prefill_attention",
             "sparse_decode": "sparse_decode_attention",
             "dense_decode": "dense_decode_attention",
             "fused_decode": "fused_sparse_decode"}

    def __init__(self, want, device="cuda"):
        self.want = want
        self.device = torch.device(device).type
        self.calls = []

    def __enter__(self):
        import quest_tpu_torch.models.llama as llama
        from quest_tpu_torch.engine.graphs import eager
        self._eager = eager()
        self._eager.__enter__()
        self._llama = llama
        self._orig = {k: getattr(llama, f) for k, f in self.NAMES.items()}
        for k, f in self.NAMES.items():
            setattr(llama, f, self._wrap(k, self._orig[k]))
        return self

    def __exit__(self, *exc):
        for k, f in self.NAMES.items():
            setattr(self._llama, f, self._orig[k])
        self._eager.__exit__(*exc)

    def _wrap(self, kernel, fn):
        taken = set()

        def call(*args, **kw):
            out = fn(*args, **kw)
            if out.device.type != self.device:
                return out
            label = self.want(kernel, kw["layer"])
            if label is not None and label not in taken:
                taken.add(label)
                l = kw["layer"]
                # Pool (and metadata for the fused kernel): the layer read.
                n_pool = 3 if kernel == "fused_decode" else 1
                args = [a[l:l + 1].clone() if 1 <= i <= n_pool else a.clone()
                        for i, a in enumerate(args)]
                kw = {k: v.clone() if torch.is_tensor(v) else v
                      for k, v in kw.items()}
                kw["layer"] = 0
                self.calls.append((kernel, label, args, kw, out.clone()))
            return out
        return call

    def check(self, name):
        """Each taken call against the plain version: per row, max|d| /
        max|plain| (max|d| where the plain row is zero, as for a row
        with no key) within REL_TOL. Returns the cases by kernel."""
        from quest_tpu_torch.ops.dense_decode import \
            dense_decode_attention_plain
        from quest_tpu_torch.ops.fused_decode import fused_sparse_decode_plain
        from quest_tpu_torch.ops.prefill import prefill_attention_plain
        from quest_tpu_torch.ops.sparse_decode import \
            sparse_decode_attention_plain
        plain = {"prefill": prefill_attention_plain,
                 "sparse_decode": sparse_decode_attention_plain,
                 "dense_decode": dense_decode_attention_plain,
                 "fused_decode": fused_sparse_decode_plain}
        cases = {}
        for kernel, label, args, kw, out in self.calls:
            want = plain[kernel](*args, **kw)
            d = (out.float() - want.float()).abs().flatten(1).amax(1)
            ref = want.float().abs().flatten(1).amax(1)
            rows = torch.where(ref > 0, d / ref.clamp_min(1e-30), d)
            err = float(rows.max())
            B = out.shape[0]
            log(f"tap[{name}, {kernel}]: B={B} rows ({label}), "
                f"{'T=%d, ' % out.shape[1] if kernel == 'prefill' else ''}"
                f"kv_lens {call_lens(kernel, args)}: per-row max rel err "
                f"{err:.2e} (limit {REL_TOL})")
            assert err <= REL_TOL, (
                f"{kernel} disagrees with its plain version on the "
                f"scheduler's batch ({name}: {label}): {err}")
            cases.setdefault(kernel, []).append(dict(
                case=f"scheduler {name}: B={B}", rows=label,
                max_abs_err=float(d.max()), max_rel_err=err))
        self.calls.clear()
        return cases


def call_lens(kernel, args):
    """The keys each row of a taken call attends to."""
    lens = args[3] if kernel == "prefill" else args[-1]
    return lens.tolist()


def scheduler_tap_rule(eng):
    """:class:`KernelTap`'s choice for a scheduler: a prefill call at the
    last layer, a dense one at the last dense layer and a sparse or
    fused one at the last layer, labelled by the kinds of rows in the
    call (read from the host's slot state while the call runs). A decode
    call holds every slot of the rank; a prefill call the prefilling
    slots the scheduler picks (``_prefill_groups``: under dp, padded with
    the group's other slots, ride-along or empty)."""
    L, skip = eng.cfg.num_layers, eng.quest.skip_layers
    layer_of = {"prefill": L - 1, "dense_decode": skip - 1,
                "sparse_decode": L - 1, "fused_decode": L - 1}
    n = eng._slots_per_group

    def call_slots(kernel):
        if kernel != "prefill":
            return range(eng._row0, eng._row0 + n)
        pf = [b for b, s in enumerate(eng.slots)
              if s is not None and s.prefilling]
        return eng._prefill_groups(pf)[eng._group(eng._row0)]

    def want(kernel, layer):
        if layer != layer_of[kernel]:
            return None
        kinds = set()
        for s in (eng.slots[b] for b in call_slots(kernel)):
            if s is None:
                kinds.add("empty")
            elif kernel != "prefill":
                kinds.add("mid-prompt" if s.prefilling else "live")
            elif not s.prefilling:
                kinds.add("ride-along")
            elif s.prefill_pos == 0:
                kinds.add("prompt start")
            elif s.prefill_pos == len(s.shared_blocks) * eng.block_tokens:
                kinds.add("after prefix hit")
            else:
                kinds.add("next chunk")
            if s is not None and s.shared_blocks:
                kinds.add("aliased")
        return ", ".join(sorted(kinds))
    return want


def check_taps(tap, name, need):
    """:meth:`KernelTap.check`, then: every kernel of ``need`` was taken
    on batches that together hold each of its row kinds."""
    cases = tap.check(name)
    for kernel, kinds in need.items():
        seen = {k for c in cases.get(kernel, [])
                for k in c["rows"].split(", ")}
        assert set(kinds) <= seen, (
            f"{name}: {kernel} was never checked on rows "
            f"{sorted(set(kinds) - seen)} (seen {sorted(seen)})")
    return cases


# Row kinds each scheduler run must have held against the plain versions.
# A prefill call on one device holds only prefilling rows; the kernel's
# ride-along (no new token, kv_len > 0) and empty (kv_len 0) rows are held
# by tests/test_torch_attention.py::test_prefill_kernel_matches_plain.
PREFILL_KINDS = ("prompt start", "next chunk", "after prefix hit",
                 "aliased")
DECODE_KINDS = ("live", "mid-prompt", "empty", "aliased")


def tap_needs(quest):
    sparse = "fused_decode" if quest.fused_decode else "sparse_decode"
    return {"prefill": PREFILL_KINDS, "dense_decode": DECODE_KINDS,
            sparse: DECODE_KINDS}


def small_scheduler_phase(fused=False, kv_dtype=torch.float32):
    """The continuous-batching scheduler on a 4-layer model (head dim
    128, GQA group 4, f32 weights, a ``kv_dtype`` KV pool) over
    :func:`scheduler_requests`. With an f32 pool it runs on the card
    against the same scheduler on the CPU's plain path (the EOS token is
    the CPU's third greedy token of uid 2): the ticks must agree at every
    step; greedy tokens per uid, the sampled request's first token, the
    prefix hits and the final block tables and lengths must be equal.
    With a bf16 pool it runs on the card alone (there greedy tokens
    follow rounding at near ties): every request gives its tokens and
    the prefix is hit. In both, :class:`KernelTap` holds the card's
    kernel calls on each kind of batch against the plain versions. With
    ``fused`` the sparse layers take the fused kernel (launches
    counted). Returns the run's numbers and the tap's cases."""
    from quest_tpu_torch.config import QuestConfig, small_tpu_model
    from quest_tpu_torch.engine.scheduler import ContinuousBatchingEngine
    from quest_tpu_torch.models.llama import init_params
    cfg = dataclasses.replace(small_tpu_model(), num_layers=4, num_heads=8,
                              num_kv_heads=2, dtype=torch.float32)
    quest = QuestConfig(page_size=16, token_budget=64, max_seq_len=2048,
                        block_pages=16, kv_dtype=kv_dtype,
                        fused_decode=fused)
    bt = quest.block_pages * quest.page_size
    params = init_params(cfg, torch.Generator().manual_seed(5),
                         device="cpu")
    kw = scheduler_kwargs(quest)

    def engine(device):
        return ContinuousBatchingEngine(cfg, quest, params, device=device,
                                        **kw)

    against_cpu = kv_dtype == torch.float32
    if against_cpu:
        pre = engine("cpu").run(scheduler_requests(cfg.vocab_size, bt))
        reqs = scheduler_requests(cfg.vocab_size, bt, eos_token_id=pre[2][2])
        gpu, cpu = engine("cuda"), engine("cpu")
    else:
        reqs = scheduler_requests(cfg.vocab_size, bt)
        gpu = engine("cuda")
    counted = {n: k for n, k in kernel_wrappers().items()
               if n in ("fused_decode",) + SPARSE_LAYER_KERNELS}
    for k in counted.values():
        k.launches = 0
    t = time.time()
    with KernelTap(scheduler_tap_rule(gpu)) as tap:
        gens, ticks = drive_lockstep([gpu, cpu] if against_cpu else [gpu],
                                     reqs)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in counted.items()}
    name = (f"{'fused' if fused else 'unfused'}, "
            f"{str(kv_dtype).split('.')[-1]} KV")
    g = gens[0]
    sampled = [r.uid for r in reqs if r.temperature > 0]
    greedy = [r.uid for r in reqs if r.temperature <= 0]
    msg = (f"scheduler[4-layer, {name}]: {len(reqs)} requests, "
           f"{len(ticks)} ticks ({ticks.count('prefill')} prefill) in "
           f"{time.time() - t:.1f} s; prefix hits {gpu.prefix_hits}; "
           f"launches {launches}")
    if against_cpu:
        c = gens[1]
        log(f"{msg}; CPU prefix hits {cpu.prefix_hits}; uid 2 stopped at "
            f"EOS after {len(c[2])} tokens; greedy uids {greedy} agree "
            f"with the CPU: {all(g[u] == c[u] for u in greedy)}")
        assert all(g[u] == c[u] for u in greedy), (
            f"greedy tokens differ from the CPU path ({name}): {g} vs {c}")
        assert all(g[u][0] == c[u][0] and len(g[u]) == len(c[u])
                   for u in sampled)
        assert (gpu.prefix_hits, gpu.prefix_hit_tokens) == (
            cpu.prefix_hits, cpu.prefix_hit_tokens)
        assert len(c[2]) < reqs[2].max_new_tokens, "uid 2 never met its EOS"
        assert torch.equal(gpu.cache.block_tab.cpu(), cpu.cache.block_tab)
        assert torch.equal(gpu.cache.seq_lens.cpu(), cpu.cache.seq_lens)
        assert gpu.pools[0].free_pages() == cpu.pools[0].free_pages()
    else:
        log(msg)
        assert all(len(g[r.uid]) == r.max_new_tokens
                   and all(0 <= x < cfg.vocab_size for x in g[r.uid])
                   for r in reqs), f"token counts or range ({name}): {g}"
        assert not gpu.cache.block_tab.any() and not gpu.cache.seq_lens.any()
    assert gpu.prefix_hits >= 1, "the prefix cache was never hit"
    assert launches["fused_decode" if fused else "sparse_decode"] > 0
    assert launches["sparse_decode" if fused else "fused_decode"] == 0
    assert all(launches[k] == launches["sparse_decode"]
               for k in SPARSE_LAYER_KERNELS), launches
    cases = check_taps(tap, f"4-layer {name}", tap_needs(quest))
    return dict(ticks=len(ticks), prefix_hits=gpu.prefix_hits,
                **launches), cases


# Full-width scheduler phase: uid -> (prompt tokens, max_new_tokens,
# temperature); uid 4 is uid 0's first 4096 tokens and 1500 of its own.
FULL_REQUESTS = {0: (6000, 32, 0.0), 1: (3000, 24, 0.0), 2: (1200, 40, 0.0),
                 3: (800, 8, 0.8), 4: (4096 + 1500, 32, 0.0),
                 5: (4500, 16, 0.0)}


def scheduler_phase(params, kernels, smi):
    """The continuous-batching scheduler serving the full-width
    Llama-3.1-8B (the serving phase's bf16 weights, not copied) with
    ``serving_quest_config(16384)`` and bf16 KV: page 32, 64-page blocks
    of 2048 tokens, 4 slots, bursts of 8, chunks of 2048 tokens, 8 usable
    blocks (512 pages). :data:`FULL_REQUESTS` in uid order: uid 4 waits
    for a slot, then for blocks until uid 0 publishes its prompt, and
    borrows two blocks; uid 5 then waits for blocks. Every tick's kernel
    launches are counted: 32 prefill a prefill tick, 2 dense and 30
    sparse a decode step; :class:`KernelTap` holds the kernel calls on
    each kind of batch against the plain versions. The rates it prints
    are this smoke run's: six requests, mostly a draining batch, so not
    the scheduler's throughput. Returns the run's numbers and the tap's
    cases."""
    from quest_tpu_torch.config import llama31_8b, serving_quest_config
    from quest_tpu_torch.engine.graphs import eager
    from quest_tpu_torch.engine.scheduler import (ContinuousBatchingEngine,
                                                  Request)
    cfg = llama31_8b()
    quest = serving_quest_config(16384, kv_dtype=torch.bfloat16)
    eng = ContinuousBatchingEngine(
        cfg, quest, params, max_batch=4, burst=8, prefill_chunk=2048,
        prefill_bucket=256, total_pages=8 * quest.block_pages, seed=0)
    assert eng.block_tokens == 2048 and eng.pools[0].total_pages == 8
    rng = np.random.default_rng(1)
    prompts = {u: rng.integers(1, cfg.vocab_size, size=n).tolist()
               for u, (n, _, _) in FULL_REQUESTS.items()}
    prompts[4] = prompts[0][:4096] + prompts[4][4096:]
    reqs = [Request(u, prompts[u], new, temperature=t)
            for u, (_, new, t) in FULL_REQUESTS.items()]
    L, skip = cfg.num_layers, quest.skip_layers
    finite, written = [], []

    def decode_calls(e):
        return e._tok_fn.calls + e._sample_fn.calls

    def serve(eng, count_prefill=False):
        """Every request through ``eng``, tick by tick, each tick's
        launches checked against its path (decode steps counted at the
        compiled steps)."""
        if count_prefill:
            model_prefill = eng.model.prefill_last

            def prefill_last(cache, toks, new_lens):
                out = model_prefill(cache, toks, new_lens)
                finite.append(torch.isfinite(out[new_lens > 0]).all())
                written.append(new_lens.sum())
                return out
            eng.model.prefill_last = prefill_last
        for r in reqs:
            eng.submit(dataclasses.replace(r))
        run = dict(gens={r.uid: [] for r in reqs}, ticks=[],
                   totals=dict.fromkeys(kernels, 0),
                   times={"prefill": [], "decode": []}, decode_steps=0,
                   generated=0)
        torch.cuda.synchronize()
        t_all = time.time()
        while eng.has_work():
            for k in kernels.values():
                k.launches = 0
            calls = decode_calls(eng)
            t = time.time()
            events = eng.step()
            torch.cuda.synchronize()
            dt = time.time() - t
            n_steps = decode_calls(eng) - calls
            got = {n: k.launches for n, k in kernels.items()}
            for n in got:
                run["totals"][n] += got[n]
            want = dict.fromkeys(kernels, 0)
            if eng.last_tick == "prefill":
                want.update(prefill=L, **layer_launches(L, 1, 0))
            else:
                want.update(dense_decode=skip * n_steps,
                            **dict.fromkeys(SPARSE_LAYER_KERNELS,
                                            (L - skip) * n_steps),
                            **layer_launches(L, n_steps, n_steps))
                run["decode_steps"] += n_steps
                run["generated"] += len(events)
            if eng.last_tick is not None:
                run["times"][eng.last_tick].append(dt)
            run["ticks"].append(eng.last_tick)
            assert got == want, (f"{eng.last_tick} tick of {n_steps} decode "
                                 f"steps: launches {got} != path {want}")
            for ev in events:
                run["gens"][ev.uid].append(ev.token)
        run["wall_s"] = time.time() - t_all
        return run

    with KernelTap(scheduler_tap_rule(eng)) as tap:      # eager
        run = serve(eng, count_prefill=True)
    gens, totals, times = run["gens"], run["totals"], run["times"]
    decode_steps, generated = run["decode_steps"], run["generated"]
    wall = run["wall_s"]
    cases = check_taps(tap, "Llama-3.1-8B, serving bf16 KV", tap_needs(quest))
    assert all(bool(f) for f in finite), "non-finite prefill logits"
    prefill_tokens = int(sum(w.item() for w in written))
    for r in reqs:
        assert len(gens[r.uid]) == r.max_new_tokens, (r.uid, len(gens[r.uid]))
        assert all(0 <= t < cfg.vocab_size for t in gens[r.uid])
    assert eng.prefix_hits >= 1, "the prefix cache was never hit"
    held = {b for ent in eng._prefixes[0].values() for b in ent}
    free = eng.pools[0].free_pages()
    assert free + len(held) == eng.pools[0].total_pages, (free, held)
    for ent in list(eng._prefixes[0].values()):
        eng.pools[0].pages_release(ent)
    eng._prefixes[0].clear()
    assert eng.pools[0].free_pages() == eng.pools[0].total_pages
    # One full burst profiled: four 3000-token prompts (all 8 blocks),
    # prefilled, then 8 decode steps at B=4.
    for u in range(4):
        eng.submit(Request(10 + u, rng.integers(1, cfg.vocab_size,
                                                size=3000).tolist(), 9))
    while eng.num_active < 4 or any(s.prefilling for s in eng.slots):
        eng.step()
    assert eng.num_active == 4 and eng.pools[0].free_pages() == 0

    def burst():
        calls = decode_calls(eng)
        eng.step()
        assert eng.last_tick == "decode" and eng.num_active == 0
        return decode_calls(eng) - calls

    with eager():                   # as phase 8 always ran it
        prof = profile_steps(burst, "scheduler")
    hits, hit_tokens, pool_b = (eng.prefix_hits, eng.prefix_hit_tokens,
                                cache_bytes(eng.cache))
    # Phase 16: the same requests on a new scheduler (the same seed) with
    # its steps captured: the run above is eager (the tap wraps the
    # kernels in Python). Tokens (the sampled request's too), ticks and
    # launches equal.
    del eng
    torch.cuda.empty_cache()
    eng = ContinuousBatchingEngine(
        cfg, quest, params, max_batch=4, burst=8, prefill_chunk=2048,
        prefill_bucket=256, total_pages=8 * quest.block_pages, seed=0)
    run_g = serve(eng)
    same = (run_g["gens"] == gens, run_g["ticks"] == run["ticks"],
            run_g["totals"] == totals)
    dec_g = sum(run_g["times"]["decode"])
    log(f"graphs[scheduler]: captured vs eager: tokens equal {same[0]} "
        f"(uid 3 sampled), ticks equal {same[1]}, launches equal "
        f"{same[2]}; {run_g['decode_steps']} decode steps at "
        f"{dec_g / run_g['decode_steps'] * 1e3:.2f} ms a step captured "
        f"against {sum(times['decode']) / decode_steps * 1e3:.2f} eager, "
        f"{run_g['generated'] / dec_g:.1f} generated tokens/s over the "
        f"decode ticks against {generated / sum(times['decode']):.1f}; "
        f"{eng.graphs.summary()}")
    assert all(same), "the captured scheduler differs from eager"
    graph_res = dict(tokens_equal=True, ticks_equal=True,
                     launches_equal=True, wall_s=run_g["wall_s"],
                     decode_ms_per_step=dec_g / run_g["decode_steps"] * 1e3,
                     generated_tokens_per_s=run_g["generated"] / dec_g,
                     **eng.graphs.summary())
    del eng
    torch.cuda.empty_cache()
    pf_s, dec_s = sum(times["prefill"]), sum(times["decode"])
    res = dict(
        wall_s=wall, ticks=len(times["prefill"]) + len(times["decode"]),
        prefill_ticks=len(times["prefill"]), prefill_tokens=prefill_tokens,
        prefill_tokens_per_s=prefill_tokens / pf_s,
        decode_ticks=len(times["decode"]), decode_steps=decode_steps,
        generated_tokens=generated, generated_tokens_per_s=generated / dec_s,
        decode_ms_per_step=dec_s / decode_steps * 1e3,
        prefix_hits=hits, prefix_hit_tokens=hit_tokens, pool_bytes=pool_b,
        launches=totals, graphs=graph_res, **prof)
    log(f"scheduler[Llama-3.1-8B, serving bf16 KV]: {len(reqs)} requests in "
        f"{wall:.1f} s, {res['ticks']} ticks (smoke-run rates, not the "
        f"scheduler's throughput); prefill {prefill_tokens} "
        f"tokens in {res['prefill_ticks']} ticks at "
        f"{res['prefill_tokens_per_s']:.0f} tokens/s; decode "
        f"{decode_steps} steps in {res['decode_ticks']} bursts, "
        f"{generated} tokens at {res['generated_tokens_per_s']:.1f} "
        f"tokens/s, {res['decode_ms_per_step']:.2f} ms a step (B=4); "
        f"prefix hits {hits} ({hit_tokens} tokens); "
        f"pool {res['pool_bytes'] / 1e9:.3f} GB; launches {totals}; "
        f"card {smi}")
    return res, cases


# ---------------------------------------------------------------------------
# Phase 9: the weight-only quantized products.
# ---------------------------------------------------------------------------

# The full-width linears of Llama-3.1-8B: (label, in, out); the lm_head
# product takes an f32 activation, the others bf16.
QUANT_SHAPES = (("wq/wo", 4096, 4096), ("wk/wv", 4096, 1024),
                ("w_gate/w_up", 4096, 14336), ("w_down", 14336, 4096),
                ("lm_head", 4096, 128256))
QUANT_ROWS = (1, 2, 4, 16)
PREFILL_CHUNK_ROWS = 2048      # rows of x the dequant pair's matmul takes
F32_KERNEL_TOL = 1e-5          # f32 kernel vs plain, max|d| / max|plain|
F32_FLOPS = 67e12              # f32 outside the tensor cores


def quant_bound(M, K, N, bits, x_dtype, out_bytes=None):
    """(ms, bound_by): the packed weights, s, x and out each moved once
    over the memory rate, or 2 M K N operations over the peak of x's type
    (bf16 tensor cores, or f32 FMA), the larger. ``out_bytes`` replaces
    the product's x and out (the dequant pass writes the whole matrix)."""
    esz = torch.empty((), dtype=x_dtype).element_size()
    nbytes = K * N * bits // 8 + 4 * N + (
        out_bytes if out_bytes is not None else M * (K + N) * esz)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if out_bytes is not None:
        return t_bytes, "bytes"
    peak = BF16_FLOPS if x_dtype == torch.bfloat16 else F32_FLOPS
    t_ops = 2 * M * K * N / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def weight_kernel_phase(timer, gen, ptxas):
    """``qgemv`` and ``dequant`` against their plain versions at every
    full-width linear of Llama-3.1-8B, int8 and int4 (RTN of a random
    bf16 weight, quantized on the card): ``qgemv`` at M = 1, 2, 4, 16 rows
    within 2e-2 (bf16) or 1e-5 (f32, the lm_head), ``dequant`` bitwise;
    each timed beside its bound, its plain version and the bf16
    ``torch.matmul`` over the unquantized weight that quantization must
    beat (the lm_head also beside the unquantized model's route, the f32
    product over its bf16 head by ``head_gemv``). Each case prints the registers and spills of the kernel
    instantiation it launches (``ptxas``: ``ptxas_kernels`` of the qgemv
    library's build log). Each bf16 ``dequant`` is also timed followed
    by the ``torch.matmul`` of a 2048-row prefill chunk with the L2 left
    as the kernel leaves it (the pair), beside that matmul alone.
    Returns each kernel's cases, the main path's first (w_gate at M = 2
    in int8)."""
    from quest_tpu_torch.models.quantize import quantize_weight
    from quest_tpu_torch.ops.head_gemv import head_gemv
    from quest_tpu_torch.ops.qdot import (dequant, dequant_plain, qgemv,
                                          qgemv_plain)
    gemv, deq = [], []
    for label, K, N in QUANT_SHAPES:
        xdt = torch.float32 if label == "lm_head" else torch.bfloat16
        w = (torch.randn((K, N), generator=gen, device="cuda")
             / math.sqrt(K)).to(torch.bfloat16)
        for bits in (8, 4):
            qw = quantize_weight(w, bits)
            for M in QUANT_ROWS:
                x = torch.randn((M, K), generator=gen, device="cuda").to(xdt)
                got = qgemv(x, qw.q, qw.s, None, bits)
                want = qgemv_plain(x, qw.q, qw.s, None, bits, xdt)
                torch.cuda.synchronize()
                err = rel_err(got, want)
                tol = REL_TOL if xdt == torch.bfloat16 else F32_KERNEL_TOL
                xb = x.to(torch.bfloat16)
                bound, by = quant_bound(M, K, N, bits, xdt)
                case = dict(
                    case=f"{label} {K}x{N} int{bits} M={M} "
                         f"{str(xdt).split('.')[-1]} x",
                    max_abs_err=float((got - want).abs().max()),
                    max_rel_err=err,
                    ms=timer(lambda: qgemv(x, qw.q, qw.s, None, bits)),
                    plain_ms=timer(lambda: qgemv_plain(x, qw.q, qw.s, None,
                                                       bits, xdt)),
                    library_ms=timer(lambda: xb @ w), bound_ms=bound,
                    bound_by=by)
                if xdt == torch.float32:
                    case["bf16_head_ms"] = timer(lambda: head_gemv(x, w))
                gemv.append(case)
                case["registers"] = registers_of(
                    ptxas, weight_instantiation("qgemv", bits, M, xdt))
                log(f"qgemv[{case['case']}]: rel err {err:.2e}, "
                    f"{case['ms'] * 1e3:.1f} us (bound {bound * 1e3:.1f} us "
                    f"{by}, plain {case['plain_ms'] * 1e3:.1f} us, bf16 "
                    f"matmul {case['library_ms'] * 1e3:.1f} us"
                    + (f", bf16 head_gemv {case['bf16_head_ms'] * 1e3:.1f} us"
                       if xdt == torch.float32 else "")
                    + f"); {case['registers']}")
                assert err <= tol, f"qgemv disagrees ({case['case']}): {err}"
            got = dequant(qw.q, qw.s, None, bits, xdt)
            want = dequant_plain(qw.q, qw.s, None, bits, xdt)
            torch.cuda.synchronize()
            assert torch.equal(got, want), f"dequant {label} int{bits}"
            out_bytes = K * N * got.element_size()
            bound, by = quant_bound(0, K, N, bits, xdt, out_bytes)
            case = dict(
                case=f"{label} {K}x{N} int{bits} -> "
                     f"{str(xdt).split('.')[-1]}",
                max_abs_err=0.0, max_rel_err=0.0,
                ms=timer(lambda: dequant(qw.q, qw.s, None, bits, xdt,
                                         out=got)),
                plain_ms=timer(lambda: dequant_plain(qw.q, qw.s, None, bits,
                                                     xdt)),
                library_ms=None, bound_ms=bound, bound_by=by,
                registers=registers_of(ptxas, weight_instantiation(
                    "dequant", bits, x_dtype=xdt)))
            pair = ""
            if xdt == torch.bfloat16:
                xs = torch.randn((PREFILL_CHUNK_ROWS, K), generator=gen,
                                 device="cuda").to(xdt)
                case["pair_ms"] = timer(lambda: xs @ dequant(
                    qw.q, qw.s, None, bits, xdt, out=got), flush=False)
                case["pair_matmul_ms"] = timer(lambda: xs @ got, flush=False)
                pair = (f"; then a {PREFILL_CHUNK_ROWS}-row matmul, L2 "
                        f"kept: {case['pair_ms'] * 1e3:.1f} us, the matmul "
                        f"alone {case['pair_matmul_ms'] * 1e3:.1f} us")
                del xs
            deq.append(case)
            log(f"dequant[{case['case']}]: bitwise, {case['ms'] * 1e3:.1f} "
                f"us (bound {bound * 1e3:.1f} us, plain "
                f"{case['plain_ms'] * 1e3:.1f} us){pair}; "
                f"{case['registers']}")
            del qw, got, want
        del w
        torch.cuda.empty_cache()
    gemv.sort(key=lambda c: not c["case"].startswith(
        "w_gate/w_up 4096x14336 int8 M=2 "))
    deq.sort(key=lambda c: not c["case"].startswith(
        "w_gate/w_up 4096x14336 int8"))
    return {"qgemv": gemv, "dequant": deq}


# ---------------------------------------------------------------------------
# Phase 10: quantized models, 4 layers, card against CPU; AWQ on the card.
# ---------------------------------------------------------------------------

def quant_launches(cfg, decode_steps, prefill_calls):
    """qgemv and dequant launches of a quantized model's run: each of the
    7 layer linears and the lm_head a call; a prefill's layer linears
    take the dequant route (more than 16 rows), its lm_head (one row a
    sequence) and every decode step's products take qgemv."""
    L = cfg.num_layers
    return dict(qgemv=(7 * L + 1) * decode_steps + prefill_calls,
                dequant=7 * L * prefill_calls)


def small_awq_phase(device="cuda", n_grid=20):
    """AWQ at int4 over the 4-layer f32 model of phase 5, given the
    salient activation channels that AWQ exists for: 8 channels of the
    residual stream scaled by 6 in the embedding and in every norm's
    weight, and 1 in 32 output columns of wv and w_up scaled by 6 (so the
    o- and down-projections' inputs have outliers too). Calibrated on one
    batch of 4 x 64 tokens, then every linear of every layer is held on
    the rows of a second, held-out batch: AWQ's output error must be at
    most RTN's. (With only the embedding scaled, as tests/
    test_quantize.py's AWQ case, the stream's outliers fade after the
    first layer, and on held-out rows AWQ lost to RTN by up to 16% on 15
    of 29 linears: alphas fitted to noise.) Returns the summed errors."""
    from quest_tpu_torch.config import QuestConfig, small_tpu_model
    from quest_tpu_torch.kv.paged_kv import init_cache
    from quest_tpu_torch.models import awq
    from quest_tpu_torch.models.llama import QuestModel, init_params
    from quest_tpu_torch.models.quantize import (QUANT_KEYS, qdot,
                                                 quantize_weight)
    cfg = dataclasses.replace(small_tpu_model(), num_layers=4, num_heads=8,
                              num_kv_heads=2, dtype=torch.float32)
    quest = QuestConfig(page_size=16, token_budget=64, max_seq_len=1024,
                        kv_dtype=torch.float32)
    params = init_params(cfg, torch.Generator().manual_seed(5), device="cpu")
    rng = np.random.default_rng(9)

    def salient(n, count):
        b = torch.ones(n)
        b[rng.choice(n, count, replace=False)] = 6.0
        return b

    boost = salient(cfg.hidden_size, 8)
    params["embed"] = params["embed"] * boost
    params["final_norm"] = params["final_norm"] * boost
    lay = params["layers"]
    for k in ("ln_attn", "ln_mlp"):
        lay[k] = lay[k] * boost
    for k in ("wv", "w_up"):
        lay[k] = lay[k] * salient(lay[k].shape[-1], lay[k].shape[-1] // 32)
    params = {k: ({kk: vv.to(device) for kk, vv in v.items()}
                  if isinstance(v, dict) else v.to(device))
              for k, v in params.items()}
    model = QuestModel(cfg, quest, params)
    toks = [torch.from_numpy(rng.integers(1, cfg.vocab_size, size=(4, 64))
                             ).to(device) for _ in range(2)]
    t = time.time()
    aparams = awq.awq_quantize_params(
        model, params, init_cache(cfg, quest, batch_size=4, device=device),
        toks[0], bits=4, n_grid=n_grid)
    held = awq.awq_calibrate(model, init_cache(cfg, quest, batch_size=4,
                                               device=device), toks[1])
    sums, worse = {"awq": 0.0, "rtn": 0.0}, []
    for name in QUANT_KEYS + ("lm_head",):
        for l, ent in enumerate(held[name]):
            w = (params["lm_head"] if name == "lm_head"
                 else params["layers"][name][l])
            a = aparams[name] if name == "lm_head" else (
                aparams["layers"][name].layer(l))
            x = ent["rows"]
            ref = x @ w
            e_awq = float(((qdot(x, a) - ref) ** 2).mean())
            e_rtn = float(((qdot(x, quantize_weight(w, 4)) - ref) ** 2)
                          .mean())
            sums["awq"] += e_awq
            sums["rtn"] += e_rtn
            if e_awq > e_rtn:
                worse.append((name, l, e_awq, e_rtn))
    log(f"awq[4-layer, int4, {device}]: calibrated and searched (n_grid "
        f"{n_grid}) in {time.time() - t:.1f} s; held-out output MSE summed "
        f"over {len(QUANT_KEYS) * cfg.num_layers + 1} linears: AWQ "
        f"{sums['awq']:.4e}, RTN {sums['rtn']:.4e}; linears where AWQ is "
        f"worse: {worse}")
    assert not worse, f"AWQ loses to RTN on held-out rows: {worse}"
    return sums


# ---------------------------------------------------------------------------
# Phase 11: full-width quantized engines.
# ---------------------------------------------------------------------------

def quantized_serving_phase(params, kernels, smi):
    """Llama-3.1-8B (the serving phase's bf16 weights) quantized on the
    card, one layer's tensor at a time, to int8 and to int4 (RTN), each
    served by a ``QuestEngine`` (default ``QuestConfig``, max_seq_len
    16384, B=2) beside a bf16 engine on the same weights: prefill of
    prompts of 5000 and 2500 tokens, then 32 greedy tokens by
    ``generate_ondevice`` with every kernel's launches checked against the
    path (a prefill's layer linears dequantize, 224 launches; its lm_head
    and each decode step's 225 products are qgemv); then prefill and 16
    decode steps timed in turns (bf16, int8, int4, then in reverse), the
    quantized steps' launches checked (225 qgemv and no dequant a step),
    and two steps of each quantized engine profiled (the device ops
    launched by phase 16's eager step held to QUANT_OPS_PER_STEP).
    Prints weight and pool bytes, prefill tokens/s, decode ms a step,
    device busy and ops a step, and the correlation of the last prefill
    logits with the bf16 engine's. Returns the numbers and the int8
    run's launches."""
    from quest_tpu_torch.config import QuestConfig, llama31_8b
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.models.quantize import quantize_params, weight_bytes
    cfg = llama31_8b()
    quest = QuestConfig(max_seq_len=16384)
    L, skip, N = cfg.num_layers, quest.skip_layers, 32
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
               for n in (5000, 2500)]
    n_prompt = sum(map(len, prompts))
    engines, wbytes, t_quant, run_counts, t_gen = {}, {}, {}, {}, {}
    engines["bf16"] = QuestEngine(cfg, quest, params, batch_size=2,
                                  device="cuda")
    wbytes["bf16"] = weight_bytes(params)
    ref = engines["bf16"].prefill(prompts)
    for bits in (8, 4):
        name = f"int{bits}"
        torch.cuda.synchronize()
        t = time.time()
        qparams = quantize_params(params, bits)
        torch.cuda.synchronize()
        t_quant[name] = time.time() - t
        engines[name] = QuestEngine(cfg, quest, qparams, batch_size=2,
                                    device="cuda")
        wbytes[name] = weight_bytes(qparams)
        del qparams
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t = time.time()
        toks = engines[name].generate_ondevice(prompts, max_new_tokens=N)
        torch.cuda.synchronize()
        t_gen[name] = time.time() - t
        got = {n: k.launches for n, k in kernels.items()}
        want = dict.fromkeys(kernels, 0)
        want.update(prefill=L, dense_decode=skip * (N - 1),
                    **dict.fromkeys(SPARSE_LAYER_KERNELS, (L - skip) * (N - 1)),
                    **quant_launches(cfg, N - 1, 1),
                    **layer_launches(L, N, N - 1, heads=0))
        log(f"quantized[{name}, generate_ondevice]: prompts "
            f"{[len(p) for p in prompts]}, {N} tokens each in "
            f"{t_gen[name]:.2f} s; launches {got}")
        assert got == want, f"{name} launches {got} != path {want}"
        assert all(len(r) == N and all(0 <= x < cfg.vocab_size for x in r)
                   for r in toks), "tokens out of range"
        run_counts[bits] = got
    order = list(engines)
    prefill_s, decode_ms, corr, last = {}, {}, {}, {}
    for name in order + order[::-1]:
        engine = engines[name]
        engine.clear()
        torch.cuda.synchronize()
        t = time.time()
        logits = engine.prefill(prompts)
        prefill_s.setdefault(name, []).append(time.time() - t)
        assert np.isfinite(logits).all(), "non-finite prefill logits"
        corr[name] = [float(np.corrcoef(logits[b], ref[b])[0, 1])
                      for b in range(2)]
        tk = torch.as_tensor(np.argmax(logits, axis=-1).astype(np.int32),
                             device="cuda")
        for k in kernels.values():
            k.launches = 0
        torch.cuda.synchronize()
        t = time.time()
        for _ in range(16):
            tk = engine.model.decode_token_step(engine.cache, tk)
        torch.cuda.synchronize()
        decode_ms.setdefault(name, []).append((time.time() - t) / 16 * 1e3)
        want = (7 * L + 1) * 16 if name != "bf16" else 0
        assert (kernels["qgemv"].launches, kernels["dequant"].launches
                ) == (want, 0), f"{name} decode-step launches"
        last[name] = tk
    # Phase 16 on the quantized engines.
    graphs = graph_engine_phase({n: engines[n] for n in order[1:]}, prompts,
                                kernels, smi)
    for name in order[1:]:
        ops = graphs[name]["eager_launched_ops_per_step"]
        assert abs(ops - QUANT_OPS_PER_STEP) <= 0.5, (
            f"{name}: {ops} device ops launched a decode step, expected "
            f"{QUANT_OPS_PER_STEP}")
    out = {}
    for name in order:
        res = dict(weight_bytes=wbytes[name],
                   pool_bytes=cache_bytes(engines[name].cache),
                   prefill_tokens_per_s=[n_prompt / x
                                         for x in prefill_s[name]],
                   decode_ms_per_step=decode_ms[name],
                   logits_corr_vs_bf16=corr[name])
        if name != "bf16":
            res.update(quantize_s=t_quant[name],
                       generate_ondevice_s=t_gen[name], graphs=graphs[name],
                       **profile_decode(engines[name], last[name], name))
        log(f"quantized[{name}]: weights {wbytes[name] / 1e9:.3f} GB"
            + (f", quantized in {t_quant[name]:.2f} s" if name != "bf16"
               else "")
            + f"; pool {res['pool_bytes'] / 1e9:.3f} GB; prefill "
            f"{' / '.join(f'{x:.0f}' for x in res['prefill_tokens_per_s'])} "
            f"tokens/s; decode "
            f"{' / '.join(f'{x:.2f}' for x in decode_ms[name])} ms/step "
            f"at B=2 (in turns: bf16, int8, int4, then reversed)"
            + (f"; device busy {res['profile_device_ms_per_step']:.2f} ms "
               f"and {res['device_ops_per_step']:.0f} ops a step; last "
               f"prefill logits' correlation with bf16 "
               f"{corr[name][0]:.4f} / {corr[name][1]:.4f} (random weights)"
               if name != "bf16" else "")
            + f"; card {smi}")
        out[name] = res
    del engines
    torch.cuda.empty_cache()
    return out, run_counts[8]


# ---------------------------------------------------------------------------
# Phase 12: the checkpoint loader on the card.
# ---------------------------------------------------------------------------

def hf_state_dict(params):
    """The parameters under HF Llama names, [out, in] (views, no copy)."""
    from quest_tpu_torch.models.loader import HF_LAYER_NAMES
    sd = {"model.embed_tokens.weight": params["embed"],
          "model.norm.weight": params["final_norm"],
          "lm_head.weight": params["lm_head"].T}
    for k, (name, tr) in HF_LAYER_NAMES.items():
        for i, w in enumerate(params["layers"][k]):
            sd[f"model.layers.{i}.{name}"] = w.T if tr else w
    return sd


def llama31_8b_hf_config():
    """Llama-3.1-8B's published config.json fields, as a namespace (the
    card machine has no transformers)."""
    import types
    return types.SimpleNamespace(
        vocab_size=128256, hidden_size=4096, intermediate_size=14336,
        num_hidden_layers=32, num_attention_heads=32, num_key_value_heads=8,
        head_dim=128, rms_norm_eps=1e-5, rope_theta=500000.0,
        max_position_embeddings=131072, tie_word_embeddings=False,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 8192})


def loader_phase(params):
    """An HF-named state dict of the serving phase's weights loaded back
    by ``params_from_state_dict`` on the card: the config from the
    published fields equals the preset, the loaded parameters equal the
    originals bit for bit."""
    from quest_tpu_torch.config import llama31_8b
    from quest_tpu_torch.models.loader import (config_from_hf,
                                               params_from_state_dict)
    cfg = config_from_hf(llama31_8b_hf_config())
    assert cfg == llama31_8b(), cfg
    torch.cuda.synchronize()
    t = time.time()
    got = params_from_state_dict(hf_state_dict(params), cfg, device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t
    same = [torch.equal(got[k], params[k])
            for k in ("embed", "final_norm", "lm_head")]
    same += [torch.equal(got["layers"][k], v)
             for k, v in params["layers"].items()]
    nbytes = sum(t.numel() * t.element_size() for t in
                 [got["embed"], got["final_norm"], got["lm_head"],
                  *got["layers"].values()])
    log(f"loader: {len(same)} stacked tensors ({nbytes / 1e9:.2f} GB) from "
        f"{32 * 9 + 3} HF tensors in {dt:.2f} s; config equals llama31_8b(); "
        f"bitwise equal: {all(same)}")
    assert all(same), "the loaded parameters differ from the originals"
    return dict(load_s=dt, bytes=nbytes)


# ---------------------------------------------------------------------------
# Phase 13: the eval harnesses at full width.
# ---------------------------------------------------------------------------

def synthetic_longbench(path, paragraphs=12):
    """Two LongBench-schema tasks of two samples each, written as
    ``passage_count.jsonl`` and ``hotpotqa.jsonl`` under ``path``:
    ``paragraphs`` paragraphs of 60 random words and 3 of them repeated
    (~5000 bytes at 12), a question, the answers."""
    rng = np.random.default_rng(4)
    words = [f"w{i}" for i in range(200)]

    def para():
        return " ".join(rng.choice(words, size=60))

    for task in ("passage_count", "hotpotqa"):
        with open(Path(path) / f"{task}.jsonl", "w") as f:
            for i in range(2):
                ps = [para() for _ in range(paragraphs)]
                ps += [ps[j] for j in rng.choice(paragraphs, 3)]
                ctx = "\n\n".join(f"Paragraph {j + 1}: {p}"
                                  for j, p in enumerate(ps))
                print(json.dumps({
                    "context": ctx, "input": f"Which paragraph names "
                    f"{words[i]}?", "answers": [str(paragraphs)]
                    if task == "passage_count" else [words[i]],
                    "all_classes": None}), file=f)


def eval_phase(cfg, params, kernels, device="cuda", warmup=3000,
               eval_tokens=128, n_garbage=12000, lb_prompt=8000):
    """The three harnesses on the port's engines, random weights and the
    byte tokenizer (accuracies mean nothing here): perplexity
    (``warmup`` prefilled tokens, then ``eval_tokens`` predictions, of
    which all but the first are teacher-forced decode steps) with the
    sparse path live and under the dense control (``skip_layers`` = all
    layers); passkey on two prompts of ``n_garbage`` filler bytes at
    depths 0.3 and 0.7, 8 new tokens; LongBench on two synthetic tasks of
    two samples each. Every call's kernel launches are checked against
    the path. Returns the numbers."""
    import tempfile
    from quest_tpu_torch.config import QuestConfig
    from quest_tpu_torch.engine.engine import QuestEngine
    from quest_tpu_torch.evals import (evaluate_longbench, evaluate_passkey,
                                       evaluate_perplexity)
    from quest_tpu_torch.ops.utils import round_up
    from quest_tpu_torch.utils.cli import ByteTokenizer
    L = cfg.num_layers
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    tok = ByteTokenizer()
    rng = np.random.default_rng(11)
    text = " ".join(rng.choice(["the", "quick", "brown", "fox", "jumps",
                                "over", "lazy", "dog", "and", "runs"],
                               size=warmup))
    ids = tok.encode(text)[:warmup + eval_tokens]
    assert len(ids) == warmup + eval_tokens
    res = {}

    def counted(engine, fn):
        """fn() with the launches counted, the decode steps counted at the
        engine's compiled steps and the prefill timed apart."""
        for k in kernels.values():
            k.launches = 0
        pre, steps = [0.0, 0], [0]
        prefill = engine.prefill

        def decode_calls():
            return sum(f.calls for f in (engine._decode_fn, engine._tok_fn,
                                         engine._nll_fn))

        def timed_prefill(*a, **kw):
            sync()
            t = time.time()
            out = prefill(*a, **kw)
            pre[0] += time.time() - t
            pre[1] += 1
            return out

        engine.prefill = timed_prefill
        calls = decode_calls()
        try:
            sync()
            t = time.time()
            value = fn()
            sync()
            wall = time.time() - t
        finally:
            del engine.prefill
        steps[0] = decode_calls() - calls
        got = {n: k.launches for n, k in kernels.items()}
        skip = engine.quest.skip_layers
        want = dict.fromkeys(kernels, 0)
        if kernels:
            want.update(prefill=L * pre[1],
                        dense_decode=min(skip, L) * steps[0],
                        **dict.fromkeys(SPARSE_LAYER_KERNELS,
                                        max(L - skip, 0) * steps[0]),
                        **layer_launches(L, pre[1] + steps[0], steps[0]))
        assert got == want, f"launches {got} != path {want}"
        return value, dict(wall_s=wall, prefill_s=pre[0],
                           prefill_calls=pre[1], decode_steps=steps[0],
                           decode_ms_per_token=(wall - pre[0]) / max(
                               steps[0], 1) * 1e3, launches=got)

    # Room for the longest request: a passkey prompt is the filler plus
    # ~250 bytes, a LongBench prompt at most lb_prompt tokens.
    max_seq = round_up(max(warmup + eval_tokens, n_garbage + 1024,
                           lb_prompt + 256), 2048)
    for label, skip in (("sparse", 2), ("dense_control", L)):
        quest = QuestConfig(max_seq_len=max_seq, skip_layers=skip)
        engine = QuestEngine(cfg, quest, params, device=device)
        ppl, r = counted(engine, lambda: evaluate_perplexity(
            engine, ids, num_eval_tokens=eval_tokens, warmup_prefill=warmup))
        assert math.isfinite(ppl), ppl
        assert r["decode_steps"] == eval_tokens - 1
        res[f"perplexity_{label}"] = dict(ppl=ppl, **r)
        log(f"evals[perplexity, {label}, budget {quest.token_budget}, "
            f"skip_layers {skip}]: ppl {ppl:.2f} over {eval_tokens} tokens "
            f"after {warmup} prefilled (random weights: the value means "
            f"nothing); {r['decode_ms_per_token']:.2f} ms a decode token; "
            f"launches {r['launches']}")
        if label == "sparse":
            pk, r = counted(engine, lambda: evaluate_passkey(
                engine, tok, n_garbage=n_garbage, iterations=2,
                max_new_tokens=8, depth_ratios=[0.3, 0.7]))
            assert pk.total == 2
            res["passkey"] = dict(correct=pk.correct, total=pk.total, **r)
            log(f"evals[passkey]: {pk.correct}/{pk.total} (random weights), "
                f"{r['prefill_calls']} prompts of ~{n_garbage} bytes, "
                f"{r['decode_steps']} decode steps at "
                f"{r['decode_ms_per_token']:.2f} ms a token")
            with tempfile.TemporaryDirectory() as d:
                synthetic_longbench(d)
                scores, r = counted(engine, lambda: evaluate_longbench(
                    engine, tok, d, ["passage_count", "hotpotqa"], lb_prompt))
            assert set(scores) == {"passage_count", "hotpotqa"} and all(
                0.0 <= v <= 100.0 for v in scores.values()), scores
            assert r["prefill_calls"] == 4
            res["longbench"] = dict(scores=scores, **r)
            log(f"evals[longbench]: scores {scores} (random weights), "
                f"{r['prefill_calls']} samples, {r['decode_steps']} decode "
                f"steps at {r['decode_ms_per_token']:.2f} ms a token")
        del engine
        if device == "cuda":
            torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# Phase 14: the tools (quest_tpu_torch/scripts), each through its run_*.
# ---------------------------------------------------------------------------

LONG_CTX = 131072 - 2 * 16         # + a burst of warm-up and 16 tokens
TEXTGEN_RUNS = {"default": ["--ab-full"], "fused": ["--fused"],
                "fp8": ["--kv-dtype", "fp8", "--meta-dtype", "fp8",
                        "--page", "32"],
                "burst8": ["--burst", "8"]}


def counted_launches(kernels, fn):
    """fn() with every kernel's count set to 0 just before and read just
    after: (fn's value, {kernel: launches})."""
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    value = fn()
    torch.cuda.synchronize()
    return value, {n: k.launches for n, k in kernels.items() if k.launches}


def tools_phase(params, kernels, smi):
    """The tools at full Llama-3.1-8B width over phase 6's bf16 weights:
    bench_textgen (32 layers, ctx 32768, budget 2048, B=1, 32 decode
    tokens: the default engine with its full-cache control, fused, fp8
    KV and metadata at page 32, bursts of 8; then ctx 131040 and 16
    decode tokens against the control), bench_kernels (its defaults
    and 32/8 heads), bench_serving (4 slots, 8 requests of 1024 tokens
    with a 512-token shared prefix, 32 generated), profile_textgen (ctx
    8192, 8 decode tokens), accuracy_delta (ctx 4096, 64 eval tokens,
    budgets 512 and 1024 and the control), accuracy_proxies on the card
    against the CPU (ctx 2048) and both examples (byte tokenizer). Each
    run's kernel launches are counted and checked against its path.
    Returns the numbers."""
    from quest_tpu_torch.config import llama31_8b
    from quest_tpu_torch.engine.graphs import eager
    from quest_tpu_torch.models.llama import TRACE_RANGES
    from quest_tpu_torch.scripts import (accuracy_delta, accuracy_proxies,
                                         bench_kernels, bench_serving,
                                         bench_textgen, example_demo,
                                         example_textgen, profile_textgen)
    from quest_tpu_torch.utils.cli import build_engine
    t_phase = time.time()
    cfg = llama31_8b()
    L, res = cfg.num_layers, {}

    def done(name, t):
        log(f"tools[{name}]: {time.time() - t:.1f} s; card {smi}")

    # bench_textgen: launches are the path's, per engine: prefill (4
    # chunks of 8192) twice, the control's once; one warm-up burst and N
    # timed steps.
    # Phase 16: each run but the bursts also under eager() (the
    # --eager flag), after its captured run.
    # The last run: Quest at the longest context of Llama-3.1-8B's 131072
    # positions that leaves room for the timed tokens and their warm-up,
    # sparse against the full-cache control, captured.
    runs = [(lb + m, ["--ctx", "32768", "--decode-tokens", "32"] + x + f)
            for lb, x in TEXTGEN_RUNS.items()
            for m, f in (("", []), ("_eager", ["--eager"]))
            if lb != "burst8" or not f]
    runs.append(("long", ["--ctx", str(LONG_CTX), "--decode-tokens", "16",
                          "--ab-full"]))
    for label, extra in runs:
        t = time.time()
        args = bench_textgen.parse_args(
            ["--layers", "0", "--budget", "2048", "--batch", "1"] + extra)
        with eager() if args.eager else contextlib.nullcontext():
            out, got = counted_launches(kernels, lambda: bench_textgen.
                                        run_bench_textgen(cfg, params, args))
        nb = args.burst
        steps = nb + -(-args.decode_tokens // nb) * nb
        chunks = -(-out["ctx"] // args.prefill_chunk)
        skip, ab = args.skip_layers, "full_cache_ms_per_token" in out
        forwards, decodes = chunks * (3 if ab else 2), steps * (2 if ab else 1)
        want = {"prefill": L * chunks * (3 if ab else 2),
                "dense_decode": skip * steps + (L * steps if ab else 0),
                **dict.fromkeys(("fused_decode",) if args.fused
                                else SPARSE_LAYER_KERNELS, (L - skip) * steps),
                **layer_launches(L, forwards + decodes, decodes)}
        log(f"tools[bench_textgen, {label}]: {json.dumps(out)}; launches "
            f"{got}")
        assert got == want, f"launches {got} != path {want}"
        assert all(math.isfinite(v) and v > 0 for k, v in out.items()
                   if k.endswith(("_ms", "_per_token", "_per_s",
                                  "speedup"))), out
        res[f"bench_textgen_{label}"] = dict(out, launches=got,
                                             seconds=time.time() - t)
        done(f"bench_textgen, {label}", t)
        torch.cuda.empty_cache()

    # bench_kernels: rates under the card's peaks, and each stage's kernel
    # launched once a timed or warm-up call (none for the plain stages).
    for label, extra in (("32/32 heads", []), ("32/8 heads",
                                              ["--kv-heads", "8"]),
                         ("32/8 heads, B=2, the layer's append and rope",
                          ["--kv-heads", "8", "--batch", "2", "--stages",
                           "append,rope,rope_prefill,rope_append"]),
                         ("B=2, the norm and the head",
                          ["--kv-heads", "8", "--batch", "2", "--stages",
                           "rms_norm,rms_norm_prefill,head_gemv"]),
                         ("a T=8192 chunk's prefill append and SiLU product",
                          ["--kv-heads", "8", "--ctx", "8192", "--stages",
                           "append_prefill,silu_mul,silu_mul_prefill"]),
                         ("B=2, the serving chunk's prefill append",
                          ["--kv-heads", "8", "--ctx", "5120", "--batch",
                           "2", "--prefill-lens", "5000,2500", "--stages",
                           "append_prefill"])):
        t = time.time()
        detail = {}
        args = bench_kernels.parse_args(extra)
        out = bench_kernels.run_bench_kernels(args, detail)
        log(f"tools[bench_kernels, {label}]: {json.dumps(out)}")
        for stage, row in detail.items():
            assert row.get("gbps", 0) <= HBM_BYTES_PER_S / 1e9, (stage, row)
            assert row.get("tflops", 0) <= BF16_FLOPS / 1e12, (stage, row)
            want = row["calls"] if row["kernel"] else 0
            assert row["launches"] == want, (stage, row)
            log(f"  {stage:16s} {row['us']:9.1f} us  " + (
                f"{row['tflops']:7.1f} TFLOP/s" if "tflops" in row else
                f"{row['gbps']:7.1f} GB/s") + f"  {row['launches']} "
                f"launches of {row['kernel']} in {row['calls']} calls")
        res[f"bench_kernels_{label}"] = dict(us=out, detail=detail)
        done(f"bench_kernels, {label}", t)
        torch.cuda.empty_cache()

    t = time.time()
    args = bench_serving.parse_args(
        ["--layers", str(L), "--max-batch", "4", "--requests", "8",
         "--prompt-len", "1024", "--gen-len", "32", "--shared-prefix", "512",
         "--ab-rounds", "1", "--block-pages", "16"])
    (cell,), got = counted_launches(kernels, lambda: bench_serving.
                                    run_bench_serving(cfg, params, args))
    log(f"tools[bench_serving]: {json.dumps(cell)}; launches {got}")
    assert cell["generated_tokens"] == args.requests * args.gen_len, cell
    assert cell["prefix_hits"] > 0, cell
    assert got.get("prefill", 0) > 0 and got.get("sparse_decode", 0) > 0, got
    res["bench_serving"] = dict(cell, launches=got)
    done("bench_serving", t)
    torch.cuda.empty_cache()

    t = time.time()
    args = profile_textgen.parse_args(
        ["--layers", str(L), "--ctx", "8192", "--decode-tokens", "8",
         "--trace-dir", str(OUT_DIR / "profile_textgen")])
    out, got = counted_launches(kernels, lambda: profile_textgen.
                                run_profile_textgen(cfg, params, args))
    ranges = out["ranges"]
    missing = [r for r in TRACE_RANGES if r != "quest_fused_decode" and not (
        r in ranges and ranges[r]["calls"] > 0
        and ranges[r]["device_ms"] > 0)]
    log(f"tools[profile_textgen]: device {out['device_ms']:.1f} ms in "
        f"{out['device_ops']} ops over 3 passes' last; ranges "
        + ", ".join(f"{n} {r['device_ms']:.2f} ms" for n, r in sorted(
            ranges.items(), key=lambda kv: -kv[1]["device_ms"]))
        + f"; launches {got}")
    assert not missing, f"ranges with no device time: {missing}"
    res["profile_textgen"] = dict(out, launches=got)
    done("profile_textgen", t)
    torch.cuda.empty_cache()

    def build(a):
        return build_engine(a, params=params)

    t = time.time()
    args = accuracy_delta.parse_args(
        ["--random", "--preset", "llama31-8b", "--ctx", "4096",
         "--eval-tokens", "64", "--gen-tokens", "16", "--budgets",
         "512,1024"])
    out, got = counted_launches(kernels, lambda: accuracy_delta.
                                run_accuracy_delta(args, build))
    control = max(out["rows"], key=lambda r: r["budget"])
    log(f"tools[accuracy_delta]: {json.dumps(out['rows'])}; launches {got}")
    assert control["delta_ppl"] == 0 and control["mean_abs_delta_nll"] == 0
    assert all(math.isfinite(v) for r in out["rows"] for v in r.values()
               if isinstance(v, float)), out["rows"]
    assert got.get("sparse_decode", 0) > 0, got
    res["accuracy_delta"] = dict(out, launches=got)
    done("accuracy_delta", t)
    torch.cuda.empty_cache()

    t = time.time()
    proxies = {}
    for dev in ("cuda", "cpu"):
        proxies[dev] = accuracy_proxies.run_accuracy_proxies(
            accuracy_proxies.parse_args(
                ["--device", dev, "--ctx", "2048", "--heads", "8",
                 "--seeds", "1", "--out",
                 str(OUT_DIR / f"accuracy_proxies_{dev}.json")]))
    worst, rows = 0.0, 0
    for key in ("config_rows", "kernel_vs_sim", "gqa_rows", "passkey_rows"):
        a, b = proxies["cuda"][key], proxies["cpu"][key]
        assert len(a) == len(b) and len(a) > 0, key
        rows += len(a)
        for ra, rb in zip(a, b):
            for f, va in ra.items():
                if isinstance(va, float):
                    worst = max(worst, abs(va - rb[f]))
                else:
                    assert va == rb[f], (key, ra, rb)
    log(f"tools[accuracy_proxies]: card against CPU over {rows} rows: "
        f"worst float gap {worst:.2e}")
    assert worst <= 1e-3, worst
    res["accuracy_proxies_max_gap"] = worst
    done("accuracy_proxies", t)

    t = time.time()
    args = example_textgen.parse_args(
        ["--random", "--preset", "llama31-8b", "--max-new-tokens", "16",
         "--max-seq-len", "4096"])
    out, got = counted_launches(kernels, lambda: example_textgen.
                                run_example_textgen(*build(args), args))
    assert len(out["tokens"]) == 16 and got.get("prefill") == L, (out, got)
    args = example_demo.parse_args(
        ["--random", "--preset", "llama31-8b", "--max-new-tokens", "16",
         "--max-seq-len", "4096"])
    demo, got2 = counted_launches(kernels, lambda: example_demo.
                                  run_example_demo(*build(args), args))
    assert len(demo["quest_tokens"]) == len(demo["full_tokens"]) == 16, demo
    log(f"tools[examples]: textgen launches {got}; demo launches {got2}, "
        f"agreement {demo['agreement']}/16, decode "
        f"{demo['quest_decode_ms']:.2f} / {demo['full_decode_ms']:.2f} ms a "
        f"token (Quest / full cache)")
    res["examples"] = dict(textgen_launches=got, demo_launches=got2,
                           demo_agreement=demo["agreement"],
                           demo_decode_ms=[demo["quest_decode_ms"],
                                           demo["full_decode_ms"]])
    done("examples", t)
    torch.cuda.empty_cache()
    res["seconds"] = time.time() - t_phase
    log(f"tools: phase 14 took {res['seconds']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 15: multi-GPU over torch.distributed.
# ---------------------------------------------------------------------------

PHASE15_DIR = OUT_DIR / "phase15"
RANK_DEADLINE_S = 300           # a spawned phase's whole run, start included
DECODE_FORCED = 8               # 15b's teacher-forced decode steps
TP_F32_TOL = 1e-4               # 15b's f32 logits, max|d| / max|ref|
TP_DTYPES = {"bf16": (torch.bfloat16, REL_TOL),
             "f32": (torch.float32, TP_F32_TOL)}   # 15b's runs: dtype, gate


def pool_pages(eng):
    """[free, total, held by the prefix registry] pages of each dp group's
    pool: after a drain, free + held == total."""
    return [[p.free_pages(), p.total_pages,
             len({b for e in reg.values() for b in e})]
            for p, reg in zip(eng.pools, eng._prefixes)]


def padded_batch(prompts, bucket=256):
    """Prompts as a [B, T] int32 batch (T a bucket multiple) and lengths."""
    T = -(-max(map(len, prompts)) // bucket) * bucket
    toks = np.zeros((len(prompts), T), np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    return toks, np.asarray([len(p) for p in prompts], np.int32)


def greedy(prefill, decode, toks, lens, steps):
    """Prefill (full logits [B, T, V]), then ``steps - 1`` greedy decode
    steps: the [B, steps] tokens."""
    logits = prefill(toks, lens)
    tok = logits[torch.arange(len(lens), device=logits.device),
                 lens.long() - 1].argmax(-1).to(torch.int32)
    del logits
    out = [tok]
    for _ in range(steps - 1):
        tok = decode(tok).argmax(-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, 1)


def world1_phase(params, kernels):
    """15a: a world of 1 over NCCL in this process (``file://`` init under
    a temporary directory, ``make_mesh(1, 1)``): the full-width
    Llama-3.1-8B (phase 6's weights, the default QuestConfig, B = 2,
    phase 6's first prompts) through ``make_sharded_fns`` against the
    unsharded model doing the same calls, and through
    ``ContinuousBatchingEngine(mesh=...)`` against the unsharded
    scheduler: greedy tokens and every kernel's launches equal; decode
    ms a step of the two in turns (printed, not gated)."""
    import tempfile

    import torch.distributed as dist
    from quest_tpu_torch.config import QuestConfig, llama31_8b
    from quest_tpu_torch.engine.scheduler import (ContinuousBatchingEngine,
                                                  Request)
    from quest_tpu_torch.kv.paged_kv import init_cache
    from quest_tpu_torch.models.llama import QuestModel
    from quest_tpu_torch.parallel import (init_sharded_cache, make_mesh,
                                          make_sharded_fns, shard_params)
    from quest_tpu_torch.parallel.tp import graph_capture
    cfg, quest = llama31_8b(), QuestConfig(max_seq_len=16384)
    PHASE15_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=PHASE15_DIR)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/init",
                            rank=0, world_size=1)
    res = {}
    try:
        mesh = make_mesh(1, 1)
        rng = np.random.default_rng(0)
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in (6000, 3000)]                 # phase 6's first
        toks_np, lens_np = padded_batch(prompts)
        toks = torch.from_numpy(toks_np).cuda()
        lens = torch.from_numpy(lens_np).cuda()
        N = 32
        model = QuestModel(cfg, quest, params)
        cache = init_cache(cfg, quest, 2)
        prefill_fn, decode_fn = make_sharded_fns(cfg, quest, mesh)
        sp = shard_params(params, mesh)      # tp = 1: the same tensors
        scache = init_sharded_cache(cfg, quest, mesh, 2)
        runs = {
            "unsharded": lambda: greedy(
                lambda t, n: model.prefill(cache, t, n),
                lambda t: model.decode_step(cache, t), toks, lens, N),
            "sharded": lambda: greedy(
                lambda t, n: prefill_fn(sp, scache, t, n)[0],
                lambda t: decode_fn(sp, scache, t)[0], toks, lens, N)}
        got = {k: counted_launches(kernels, f) for k, f in runs.items()}
        (tu, cu), (ts, cs) = got["unsharded"], got["sharded"]
        log(f"15a: world 1 over NCCL (decode steps captured: "
            f"{graph_capture(mesh)}), make_sharded_fns vs the unsharded "
            f"model, {N} greedy tokens of prompts {lens_np.tolist()}: "
            f"tokens equal {bool(torch.equal(tu, ts))}; launches {cs}")
        assert graph_capture(mesh), "15a: NCCL steps are not captured"
        assert torch.equal(tu, ts), "15a: sharded tokens differ"
        assert cs == cu, f"15a: launches {cs} != unsharded {cu}"
        want = dict(prefill=cfg.num_layers,
                    dense_decode=quest.skip_layers * (N - 1),
                    **dict.fromkeys(SPARSE_LAYER_KERNELS, (
                        cfg.num_layers - quest.skip_layers) * (N - 1)),
                    # The prefill's head takes every row (the widened
                    # chunks), each decode step's head_gemv.
                    **layer_launches(cfg.num_layers, N, N - 1, heads=N - 1))
        assert cs == want, f"15a: launches {cs} != the path's {want}"
        # Decode ms a step, in turns (unsharded, sharded, sharded,
        # unsharded), 16 steps from the current state each.
        steps, ms = 16, {"unsharded": [], "sharded": []}
        tok = tu[:, -1].contiguous()
        for name in ("unsharded", "sharded", "sharded", "unsharded"):
            step = ((lambda t: model.decode_step(cache, t))
                    if name == "unsharded" else
                    (lambda t: decode_fn(sp, scache, t)[0]))
            torch.cuda.synchronize()
            t0 = time.time()
            t = tok
            for _ in range(steps):
                t = step(t).argmax(-1).to(torch.int32)
            torch.cuda.synchronize()
            ms[name].append((time.time() - t0) / steps * 1e3)
        log(f"15a: decode ms/step at B=2 in turns: unsharded "
            f"{' / '.join(f'{x:.2f}' for x in ms['unsharded'])}, sharded "
            f"(world 1) {' / '.join(f'{x:.2f}' for x in ms['sharded'])}")
        del model, cache, scache
        torch.cuda.empty_cache()
        # The scheduler with and without the mesh, on the same requests.
        reqs = [Request(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, (32, 24)))]
        sched = {}
        for name, kw in (("unsharded", dict(device="cuda")),
                         ("mesh", dict(mesh=mesh))):
            eng = ContinuousBatchingEngine(cfg, quest, params, max_batch=2,
                                           **kw)
            outs, c = counted_launches(kernels, lambda: eng.run(
                [dataclasses.replace(r) for r in reqs]))
            drained = all(f + h == t for f, t, h in pool_pages(eng))
            sched[name] = (outs, c, drained)
            del eng
            torch.cuda.empty_cache()
        (ou, cu, _), (om, cm, dm) = sched["unsharded"], sched["mesh"]
        log(f"15a: ContinuousBatchingEngine(mesh=(1, 1)) vs unsharded: "
            f"tokens equal {om == ou}, launches {cm}, pools drained {dm}")
        assert om == ou, "15a: the mesh scheduler's tokens differ"
        assert cm == cu, f"15a: scheduler launches {cm} != {cu}"
        assert dm, "15a: the mesh scheduler's pool is not drained"
        res = dict(tokens_equal=True, launches=cs,
                   decode_ms_per_step=ms, scheduler_launches=cm)
    finally:
        dist.destroy_process_group()
    return res


def spawn_ranks(fn, world, root):
    """``fn(rank, world, root)`` on ``world`` spawned ranks; the ranks are
    killed and the phase fails at RANK_DEADLINE_S or when one fails."""
    ctx = torch.multiprocessing.start_processes(
        fn, args=(world, str(root)), nprocs=world, join=False,
        start_method="spawn")
    deadline = time.time() + RANK_DEADLINE_S
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.time())):
            if time.time() > deadline:
                raise RuntimeError(f"{fn.__name__}: the ranks passed their "
                                   f"{RANK_DEADLINE_S} s deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()


def rank_group(rank, world, root, name):
    """A spawned rank's setup: one thread, the one card, gloo over a
    ``file://`` store (gloo takes CUDA tensors in its collectives by
    staging them through the host; NCCL refuses two ranks on one card),
    a 60 s collective timeout."""
    from datetime import timedelta

    import torch.distributed as dist
    torch.set_num_threads(1)
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{root}/init_{name}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))


def four_layer_config(dtype):
    from quest_tpu_torch.config import llama31_8b
    return dataclasses.replace(llama31_8b(), num_layers=4, dtype=dtype)


def tp_model(dtype):
    """15b's model in ``dtype``: the full-width 4-layer config, the pool in
    the same dtype, weights from the parent's seed."""
    from quest_tpu_torch.config import QuestConfig
    from quest_tpu_torch.models.llama import init_params
    cfg = four_layer_config(dtype)
    quest = QuestConfig(max_seq_len=16384, kv_dtype=dtype)
    return cfg, quest, init_params(cfg, torch.Generator(
        device="cuda").manual_seed(15), device="cuda")


def rank_tp(rank, world, root):
    """15b's rank, for each of TP_DTYPES: its tp = 2 shard of the
    full-width 4-layer model, the prefill's last logits
    (``make_serving_fns``) and DECODE_FORCED decode steps
    (``make_sharded_fns``) fed the unsharded engine's tokens; writes its
    logits and launches."""
    import torch.distributed as dist
    from quest_tpu_torch.parallel import (init_sharded_cache, make_mesh,
                                          make_serving_fns, make_sharded_fns,
                                          shard_params)
    root = Path(root)
    rank_group(rank, world, root, "tp")
    try:
        mesh = make_mesh(1, world)
        for name, (dtype, _) in TP_DTYPES.items():
            cfg, quest, params = tp_model(dtype)
            sp = shard_params(params, mesh)
            del params
            prefill_last, _, _ = make_serving_fns(cfg, quest, mesh)
            _, decode_fn = make_sharded_fns(cfg, quest, mesh)
            inp = np.load(root / f"tp_inputs_{name}.npz")
            toks, lens, forced = (torch.from_numpy(inp[k]).cuda()
                                  for k in ("toks", "lens", "forced"))
            cache = init_sharded_cache(cfg, quest, mesh, toks.shape[0])

            def run():
                last, _ = prefill_last(sp, cache, toks, lens)
                logits = [last[:, 0]]
                for t in forced:
                    logits.append(decode_fn(sp, cache, t)[0])
                return torch.stack(logits)
            logits, launches = counted_launches(kernel_wrappers(), run)
            np.save(root / f"tp_logits_{name}_r{rank}.npy",
                    logits.float().cpu().numpy())
            (root / f"tp_launches_{name}_r{rank}.json").write_text(
                json.dumps(launches))
            del sp, cache
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()


def dp_requests(vocab):
    """15c's requests: four prompts of 700-2300 tokens on the four slots
    and a fifth that waits for the first slot to free, so its prefill
    ticks have one prefilling row in one dp group and none in the other
    (that group's call pads with a decoding slot)."""
    from quest_tpu_torch.engine.scheduler import Request
    rng = np.random.default_rng(15)
    return [Request(uid=i, prompt=rng.integers(1, vocab, size=n).tolist(),
                    max_new_tokens=k)
            for i, (n, k) in enumerate(zip((1500, 700, 2300, 900, 1100),
                                           (16, 24, 8, 12, 10)))]


def dp_engine(mesh=None):
    """15c's scheduler: the full-width 4-layer model in f32 (f32 pool), 4
    slots, prompts in chunks of 1024 tokens."""
    from quest_tpu_torch.config import QuestConfig
    from quest_tpu_torch.engine.scheduler import ContinuousBatchingEngine
    from quest_tpu_torch.models.llama import init_params
    cfg = four_layer_config(torch.float32)
    quest = QuestConfig(max_seq_len=4096, kv_dtype=torch.float32)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(16),
                         device="cuda")
    kw = dict(mesh=mesh) if mesh is not None else dict(device="cuda")
    return cfg, ContinuousBatchingEngine(cfg, quest, params, max_batch=4,
                                         prefill_chunk=1024, **kw)


def rank_dp(rank, world, root):
    """15c's rank: ``ContinuousBatchingEngine(mesh=(2, 1))`` over the
    requests; writes every request's tokens, each group pool's pages, its
    launches and each prefill tick's prefilling slots a dp group."""
    import torch.distributed as dist
    from quest_tpu_torch.parallel import make_mesh
    root = Path(root)
    rank_group(rank, world, root, "dp")
    try:
        cfg, eng = dp_engine(make_mesh(world, 1))
        tick, per_group = eng._prefill_tick, []

        def prefill_tick(pf):
            per_group.append([sum(eng._group(b) == g for b in pf)
                              for g in range(eng.dp)])
            return tick(pf)
        eng._prefill_tick = prefill_tick
        outs, launches = counted_launches(kernel_wrappers(),
                                 lambda: eng.run(dp_requests(cfg.vocab_size)))
        (root / f"dp_r{rank}.json").write_text(json.dumps(dict(
            outs={str(k): v for k, v in outs.items()}, launches=launches,
            pools=pool_pages(eng), prefill_groups=per_group)))
    finally:
        dist.destroy_process_group()


def multi_rank_phase(kernels):
    """15b and 15c: two ranks on the one card over gloo, spawned after
    every kernel is built (the ranks load the libraries), in a directory
    of their own (a fresh ``file://`` store each run). 15b: tp = 2, the
    full-width 4-layer model in bf16 and in f32, each teacher-forced
    against the unsharded engine's prefill and DECODE_FORCED decode
    steps: logits within TP_DTYPES' gate (max |d| / max |ref|) and each
    rank's launches equal to the unsharded path's; the greedy tokens
    that agree are printed. 15c: (dp, tp) = (2, 1), the 4-layer f32
    scheduler: every request's tokens equal to the unsharded scheduler's
    and both groups' pools drained."""
    import tempfile

    from quest_tpu_torch.kv.paged_kv import init_cache
    from quest_tpu_torch.models.llama import QuestModel
    PHASE15_DIR.mkdir(parents=True, exist_ok=True)
    root = Path(tempfile.mkdtemp(dir=PHASE15_DIR))
    res = {}
    # 15b references: the unsharded 4-layer engine, greedy, per dtype.
    refs = {}
    for name, (dtype, _) in TP_DTYPES.items():
        cfg, quest, params = tp_model(dtype)
        model = QuestModel(cfg, quest, params)
        rng = np.random.default_rng(1)
        toks_np, lens_np = padded_batch([
            rng.integers(1, cfg.vocab_size, size=n).tolist()
            for n in (5000, 2500)])                         # phase 6's shape
        toks, lens = torch.from_numpy(toks_np).cuda(), torch.from_numpy(
            lens_np).cuda()
        cache = init_cache(cfg, quest, 2)

        def reference():
            logits = [model.prefill_last(cache, toks, lens)[:, 0]]
            forced = []
            for _ in range(DECODE_FORCED):
                forced.append(logits[-1].argmax(-1).to(torch.int32))
                logits.append(model.decode_step(cache, forced[-1]))
            return torch.stack(logits), torch.stack(forced)
        (ref, forced), want = counted_launches(kernels, reference)
        np.savez(root / f"tp_inputs_{name}.npz", toks=toks_np, lens=lens_np,
                 forced=forced.cpu().numpy())
        refs[name] = (ref.float().cpu().numpy(), want)
        del model, params, cache, ref
        torch.cuda.empty_cache()
    t0 = time.time()
    spawn_ranks(rank_tp, 2, root)
    log(f"15b: tp = 2 over gloo on one card, 4 layers at full width, "
        f"prefill of {lens_np.tolist()} + {DECODE_FORCED} teacher-forced "
        f"decode steps, {' and '.join(TP_DTYPES)}, in "
        f"{time.time() - t0:.1f} s")
    for name, (ref, want) in refs.items():
        tol = TP_DTYPES[name][1]
        errs, agree = [], []
        for r in range(2):
            got = np.load(root / f"tp_logits_{name}_r{r}.npy")
            errs.append(float(np.abs(got - ref).max() / np.abs(ref).max()))
            agree.append(int((got.argmax(-1) == ref.argmax(-1)).sum()))
            launches = json.loads(
                (root / f"tp_launches_{name}_r{r}.json").read_text())
            assert launches == want, \
                f"15b {name} rank {r}: launches {launches} != {want}"
        log(f"15b {name}: logits rel err "
            f"{', '.join(f'{e:.2e}' for e in errs)} (limit {tol}); greedy "
            f"tokens equal at {agree} of {ref.shape[0] * ref.shape[1]} "
            f"positions; launches {want} on each rank")
        assert max(errs) <= tol, f"15b {name}: sharded logits differ: {errs}"
        res[f"15b_{name}"] = dict(rel_err=errs, limit=tol,
                                  greedy_agree=agree, launches=want,
                                  positions=ref.shape[0] * ref.shape[1])
    # 15c: the scheduler at (dp, tp) = (2, 1) against the unsharded one.
    cfg, eng = dp_engine()
    outs, want = counted_launches(kernels, lambda: eng.run(dp_requests(
        cfg.vocab_size)))
    del eng
    torch.cuda.empty_cache()
    t0 = time.time()
    spawn_ranks(rank_dp, 2, root)
    outs = {str(k): v for k, v in outs.items()}
    for r in range(2):
        got = json.loads((root / f"dp_r{r}.json").read_text())
        assert got["outs"] == outs, f"15c rank {r}: tokens differ"
        assert all(f + h == t for f, t, h in got["pools"]), \
            f"15c rank {r}: pools not drained {got['pools']}"
        assert any(a != b for a, b in got["prefill_groups"]), \
            f"15c rank {r}: no prefill tick with unequal groups"
    log(f"15c: (dp, tp) = (2, 1) scheduler over gloo, 4 layers f32, "
        f"{len(outs)} requests in {time.time() - t0:.1f} s: every request's "
        f"tokens equal to the unsharded scheduler's, both groups' pools "
        f"drained (rank launches {got['launches']}, unsharded {want}; "
        f"prefilling slots a group each prefill tick "
        f"{got['prefill_groups']})")
    res["15c"] = dict(requests=len(outs), tokens_equal=True,
                      launches_rank=got["launches"], launches_unsharded=want)
    return res


# ---------------------------------------------------------------------------
# Phase 16: the decode steps captured once as CUDA graphs and replayed.
# ---------------------------------------------------------------------------

GRAPH_TOL = 2e-2        # decode logits, replay vs eager, if not bitwise


def graph_engine_phase(engines, prompts, kernels, smi, N=32, steps=16):
    """Phase 16 on full-width engines at B=2 (phase 6's four, phase 11's
    int8 and int4): for each, ``generate_ondevice`` of ``prompts`` under
    ``eager()`` and captured gives the same N greedy tokens with the same
    launches; two ``decode`` steps from the state it leaves give logits
    bit for bit (else the difference is printed and held within
    GRAPH_TOL); then ``steps`` token steps timed eager, graph, graph,
    eager (wall ms a step, and host ms to enqueue one step: the host's
    time before the closing synchronize), and two steps of each
    profiled (device busy ms, and device ops a step recorded and
    launched). Prints the
    captures' seconds (capture and instantiate) and pool bytes.
    Returns the numbers by engine."""
    from quest_tpu_torch.engine.graphs import eager
    out = {}
    for name, engine in engines.items():
        runs = {}
        for mode in ("eager", "graph"):
            ctx = eager() if mode == "eager" else contextlib.nullcontext()
            engine.clear()
            with ctx:
                toks, got = counted_launches(kernels, lambda: engine.
                                             generate_ondevice(prompts, N))
                last = np.asarray(toks)[:, -1]
                l1 = engine.decode(last)
                l2 = engine.decode(np.argmax(l1, -1))
            runs[mode] = (toks, got, l1, l2)
        (te, ce, e1, e2), (tg, cg, g1, g2) = runs["eager"], runs["graph"]
        diff = max(float(np.abs(a - b).max()) for a, b in ((e1, g1),
                                                          (e2, g2)))
        ref = max(float(np.abs(e1).max()), float(np.abs(e2).max()))
        same = ("bit for bit" if diff == 0 else
                f"max|d| {diff:.3e} (rel {diff / ref:.2e})")
        log(f"graphs[{name}]: {N} greedy tokens captured vs eager equal "
            f"{te == tg}; launches {cg} (eager {ce}); decode logits of two "
            f"replayed steps {same}")
        assert te == tg, f"{name}: captured tokens differ from eager"
        assert cg == ce, f"{name}: replayed launches {cg} != eager {ce}"
        assert diff <= GRAPH_TOL * ref, f"{name}: logits differ by {diff}"
        # Timing in turns, from a fresh prefill.
        engine.clear()
        engine.prefill(prompts)
        tk = torch.as_tensor(np.asarray(tg, np.int32)[:, 0], device="cuda")
        wall, enq = {"eager": [], "graph": []}, {"eager": [], "graph": []}
        for mode in ("eager", "graph", "graph", "eager"):
            ctx = eager() if mode == "eager" else contextlib.nullcontext()
            with ctx:
                torch.cuda.synchronize()
                t = time.perf_counter()
                for _ in range(steps):
                    tk = engine._tok_fn(engine.cache, tk)
                t_enq = time.perf_counter()
                torch.cuda.synchronize()
                t_end = time.perf_counter()
            wall[mode].append((t_end - t) / steps * 1e3)
            enq[mode].append((t_enq - t) / steps * 1e3)
        tk = tk.clone()
        with eager():
            prof_e = profile_decode(engine, tk, f"{name}_eager")
        prof_g = profile_decode(engine, tk, f"{name}_graph", graph=True)
        summ = engine.graphs.summary()
        busy = "profile_device_ms_per_step"
        res = dict(tokens_equal=True, launches=cg, logits_max_abs_diff=diff,
                   wall_ms_per_step=wall, enqueue_ms_per_step=enq,
                   eager_device_ms_per_step=prof_e[busy],
                   graph_device_ms_per_step=prof_g[busy],
                   eager_device_ops_per_step=prof_e["device_ops_per_step"],
                   eager_launched_ops_per_step=prof_e[
                       "launched_ops_per_step"],
                   graph_device_ops_per_step=prof_g["device_ops_per_step"],
                   profile_eager=prof_e, profile_graph=prof_g, **summ)
        log(f"graphs[{name}]: wall ms/step eager "
            f"{' / '.join(f'{x:.2f}' for x in wall['eager'])}, graph "
            f"{' / '.join(f'{x:.2f}' for x in wall['graph'])} (turns E G G "
            f"E); host enqueue ms/step eager "
            f"{' / '.join(f'{x:.3f}' for x in enq['eager'])}, graph "
            f"{' / '.join(f'{x:.3f}' for x in enq['graph'])}; device busy "
            f"ms/step eager {res['eager_device_ms_per_step']:.2f}, graph "
            f"{res['graph_device_ms_per_step']:.2f}; device ops a step "
            f"eager {res['eager_device_ops_per_step']:.1f} (launched "
            f"{res['eager_launched_ops_per_step']:.1f}), graph "
            f"{res['graph_device_ops_per_step']:.1f}; {summ['graphs']} "
            f"graphs captured in {summ['capture_s']:.2f} s, pool "
            f"{summ['pool_bytes'] / 2**20:.1f} MiB; card {smi}")
        out[name] = res
    return out


# name: (source, the TPU kernel it replaces, the path whose run gives its
# launch count: a serving engine, "probe" for the probe path, None where
# no path launches it)
KERNEL_META = {
    "sparse_decode": ("quest_tpu_torch/csrc/sparse_decode.cu",
                      "quest_tpu/ops/sparse_decode.py:498", "unfused"),
    "dense_decode": ("quest_tpu_torch/csrc/dense_decode.cu",
                     "quest_tpu/ops/dense_decode.py:181", "unfused"),
    "prefill": ("quest_tpu_torch/csrc/prefill.cu",
                "quest_tpu/ops/prefill.py:245", "unfused"),
    "estimate": ("quest_tpu_torch/csrc/estimate.cu",
                 "quest_tpu/ops/estimate.py:229", "unfused"),
    "topk_select": ("quest_tpu_torch/csrc/topk_select.cu",
                    "exp/select_compile.py:48", "unfused"),
    "fused_decode": ("quest_tpu_torch/csrc/fused_decode.cu",
                     "quest_tpu/ops/fused_decode.py:606", "fused"),
    "copy_probe": ("quest_tpu_torch/csrc/copy_probe.cu",
                   "exp/gather_ab.py:88", "probe"),
    "select_pieces": ("quest_tpu_torch/csrc/select_pieces.cu",
                      "exp/select_compile2.py:73", "probe"),
    # No Pallas counterpart: they replace XLA's fusion of the JAX qdot.
    "qgemv": ("quest_tpu_torch/csrc/qgemv.cu",
              "quest_tpu/models/quantize.py:84", "quantized"),
    "dequant": ("quest_tpu_torch/csrc/qgemv.cu",
                "quest_tpu/models/quantize.py:84", "quantized"),
    # No Pallas counterpart: they replace XLA's fusions of the JAX
    # append_decode_at and the jitted apply_rope. The decode step runs
    # both in one launch (rope_append: the append's kernel with its rotate
    # flag); the standalone append runs in bench_kernels' append stage
    # (phase 14), rope at every prefill chunk.
    "append_decode": ("quest_tpu_torch/csrc/append.cu",
                      "quest_tpu/kv/paged_kv.py:354", "tools"),
    "rope": ("quest_tpu_torch/csrc/rope.cu", "quest_tpu/ops/rope.py:85",
             "unfused"),
    "rope_append": ("quest_tpu_torch/csrc/append.cu",
                    "quest_tpu/kv/paged_kv.py:354", "unfused"),
    # No Pallas counterpart: they replace XLA's fusions of the JAX
    # rms_norm (with the residual add before it) and of the lm_head's f32
    # dot over the bf16 head.
    "rms_norm": ("quest_tpu_torch/csrc/rms_norm.cu",
                 "quest_tpu/ops/rms_norm.py:16", "unfused"),
    "head_gemv": ("quest_tpu_torch/csrc/head_gemv.cu",
                  "quest_tpu/models/llama.py:329", "unfused"),
    # No Pallas counterpart: they replace XLA's fusions of the JAX
    # append_prefill_at and of the MLP's jax.nn.silu(g) * u.
    "append_prefill": ("quest_tpu_torch/csrc/append.cu",
                       "quest_tpu/kv/paged_kv.py:446", "unfused"),
    "silu_mul": ("quest_tpu_torch/csrc/silu_mul.cu",
                 "quest_tpu/models/llama.py:281", "unfused"),
}
# A second TPU kernel that the same CUDA kernel replaces.
ALSO_REPLACES = {"copy_probe": "exp/dma_probe.py:111",
                 "rope_append": "quest_tpu/ops/rope.py:85"}


def tool_launches(tools, kname):
    """A kernel's launches in phase 14's bench_kernels runs (``tools``:
    tools_phase's results), by the stage's key."""
    return sum(r["detail"][kname]["launches"] for n, r in tools.items()
               if n.startswith("bench_kernels_") and kname in r["detail"])


# Phase 17: Mellum2-12B-A2.5B's kernels and one engine tick.

def moe_case(gen, rows, H=2304, E=64, I=896, k=8):
    """The router and the experts' path that ``models/llama.py`` takes
    for ``rows`` rows, against the plain versions; every third row idle
    (row 1 when there are fewer than three)."""
    from quest_tpu_torch.ops.moe import (KERNEL_ROWS, moe_experts,
                                         moe_experts_grouped,
                                         moe_experts_plain, moe_route,
                                         moe_route_plain)
    h = torch.randn(rows, H, generator=gen, device="cuda").bfloat16()
    wr = (torch.randn(H, E, generator=gen, device="cuda")
          / H ** 0.5).bfloat16()
    wg, wu = ((torch.randn(E, H, I, generator=gen, device="cuda")
               / H ** 0.5).bfloat16() for _ in range(2))
    wd = (torch.randn(E, I, H, generator=gen, device="cuda")
          / I ** 0.5).bfloat16()
    ids, wts = moe_route(h, wr, k)
    pids, pwts = moe_route_plain(h, wr, k)
    # Rows whose k-th and next logits lie within 1e-4 may pick either:
    # the kernel sums the logits in another order.
    top = (h.float() @ wr.float()).topk(k + 1).values
    clear = top[:, k - 1] - top[:, k] > 1e-4
    ids_equal = bool(torch.equal(ids.sort(-1).values[clear],
                                 pids.sort(-1).values[clear]))
    wts_err = float((wts.sort(-1).values - pwts.sort(-1).values)[clear]
                    .abs().max())
    idx = torch.arange(rows, device="cuda")
    active = idx % 3 != 1 if rows > 2 else idx != 1
    path = moe_experts if rows <= KERNEL_ROWS else moe_experts_grouped
    c1 = torch.zeros(1, dtype=torch.int32, device="cuda")
    c2 = torch.zeros(1, dtype=torch.int32, device="cuda")
    got = path(h, ids, wts, wg, wu, wd, active, c1)
    want = moe_experts_plain(h, ids, wts, wg, wu, wd, active, c2)
    torch.cuda.synchronize()
    read = len(set(ids[active].flatten().tolist()))
    case = dict(rows=rows, path=path.__name__, ids_equal=ids_equal,
                near_ties=int((~clear).sum()), wts_max_abs_err=wts_err, rel_err=rel_err(got, want),
                experts_read=int(c1), plain_read=int(c2), expected_read=read,
                idle_zero=not bool(got[~active].any()))
    log(f"  moe {rows} rows ({path.__name__}): {case}")
    ok = (ids_equal and wts_err <= 1e-5 and case["rel_err"] <= MELLUM_TOL
          and int(c1) == int(c2) == read and case["idle_zero"])
    if not ok:
        raise AssertionError(f"phase 17 moe at {rows} rows: {case}")
    return case


POISON_V = 100.0                 # values of the block unmapped entries name


def window_cache(gen, lens, low, W=1024, Hkv=4, D=128, page=16, bpp=64):
    """A one-layer pool [1, Hkv, pages, 2, page, D] (bf16) and a block
    table that maps, for each row, only the blocks holding its tokens
    from ``low[b]`` to ``lens[b]``, as a window layer's table does; the
    others name block 0, whose keys are 2.0 and values POISON_V, so a
    kernel that reads it strays by tens."""
    bt = bpp * page
    NB = (max(lens) + bt - 1) // bt
    tab = torch.zeros(len(lens), NB, dtype=torch.int32)
    nxt = 1
    for b, (lo, n) in enumerate(zip(low, lens)):
        for blk in range(lo // bt, (n + bt - 1) // bt):
            tab[b, blk] = nxt
            nxt += 1
    kv = torch.randn(1, Hkv, nxt * bpp, 2, page, D, generator=gen,
                     device="cuda").bfloat16()
    kv[0, :, :bpp, 0] = 2.0
    kv[0, :, :bpp, 1] = POISON_V
    return kv, tab.to(kv.device)


def plant(kv, tab, b, t, v, bpp=64):
    """Token ``t`` of row ``b``: keys 2.0 (a score of 22.6 against a query
    of ones at head 128), values ``v``."""
    page = kv.shape[-2]
    blk, off = divmod(t, bpp * page)
    pg = int(tab[b, blk]) * bpp + off // page
    kv[0, :, pg, 0, off % page] = 2.0
    kv[0, :, pg, 1, off % page] = v


def window_cases(gen, W=1024, Hq=32, Hkv=4, D=128, bpp=64):
    """Decode and prefill attention with the window against their plain
    versions, with random queries and with the edge planted: for decode,
    at each row's first key in the window (value +4) and the key before
    it (value -4), under a query of ones, the output is 4 where the edge
    is right and 0 where it is one key off either way; for prefill, the
    same two keys below one query row, which rows around it see in turn
    (-4, 0, +4, then neither)."""
    from quest_tpu_torch.ops.dense_decode import (
        dense_decode_attention, dense_decode_attention_plain)
    from quest_tpu_torch.ops.prefill import (prefill_attention,
                                             prefill_attention_plain)
    out = []
    lens = [1, 1023, 1024, 1025, 2049, 4100, 131072, 60001]
    low = [max(0, n - W - 1) for n in lens]
    kv, tab = window_cache(gen, lens, low, W, Hkv, D, bpp=bpp)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    kw = dict(sm_scale=D ** -0.5, layer=0, block_tab=tab, block_pages=bpp,
              window=W)
    q = torch.randn(len(lens), Hq, D, generator=gen, device="cuda").bfloat16()
    for b, n in enumerate(lens):
        if n > W:
            plant(kv, tab, b, n - W, 4.0, bpp)
            plant(kv, tab, b, n - W - 1, -4.0, bpp)
    for label, qq in (("random", q), ("edge", torch.ones_like(q))):
        got = dense_decode_attention(qq, kv, lens_t, **kw)
        want = dense_decode_attention_plain(qq, kv, lens_t, **kw)
        case = dict(kernel="dense_decode", case=label, rel_err=rel_err(
            got, want), max_abs_err=float((got - want).abs().max()))
        if label == "edge":
            edge = [float(want[b].mean()) for b, n in enumerate(lens)
                    if n > W]
            case["edge_out"] = edge
            if min(edge) < 3.9:
                raise AssertionError(f"phase 17: the plain decode edge "
                                     f"reads {edge}")
        log(f"  window decode {case}")
        out.append(case)
        if case["rel_err"] > MELLUM_TOL:
            raise AssertionError(f"phase 17 window decode: {case}")
    # Prefill: two rows' chunks, the second past its first block, which a
    # window layer no longer holds.
    T = 1200
    offs, news = [0, 3000], [1200, 900]
    kv_lens = [o + n for o, n in zip(offs, news)]
    low = [max(0, o - W) for o in offs]
    kv, tab = window_cache(gen, kv_lens, low, W, Hkv, D, bpp=bpp)
    # Row 0: the edge of query 1100 (keys 77 and 76); row 1: of 3500.
    for b, p0 in ((0, 1100), (1, 3500)):
        plant(kv, tab, b, p0 - W + 1, 4.0, bpp)
        plant(kv, tab, b, p0 - W, -4.0, bpp)
    offs_t = torch.tensor(offs, dtype=torch.int32, device="cuda")
    kvl_t = torch.tensor(kv_lens, dtype=torch.int32, device="cuda")
    kw = dict(sm_scale=D ** -0.5, layer=0, block_tab=tab, block_pages=bpp,
              window=W)
    real = (torch.arange(T, device="cuda")[None]
            < torch.tensor(news, device="cuda")[:, None])
    qp = torch.randn(2, T, Hq, D, generator=gen, device="cuda").bfloat16()
    for label, qq in (("random", qp), ("edge", torch.ones_like(qp))):
        got = prefill_attention(qq, kv, offs_t, kvl_t, **kw)
        want = prefill_attention_plain(qq, kv, offs_t, kvl_t, **kw)
        case = dict(kernel="prefill", case=label,
                    rel_err=rel_err(got[real], want[real]),
                    max_abs_err=float((got - want)[real].abs().max()))
        if label == "edge":
            # Row 0's queries 75-77 and 1099-1101: -4 (key 76 alone),
            # 0 (both), ..., 0, +4 (key 77 alone), then neither.
            m = want[0].mean(dim=(1, 2))
            case["edge_out"] = [round(float(m[i]), 3)
                                for i in (76, 77, 1099, 1100, 1101)]
            e = case["edge_out"]
            if not (e[0] < -3.9 and abs(e[1]) < 0.1 and abs(e[2]) < 0.1
                    and e[3] > 3.9 and abs(e[4]) < 1.0):
                raise AssertionError(f"phase 17: the plain prefill edge "
                                     f"reads {e}")
        log(f"  window prefill {case}")
        out.append(case)
        if case["rel_err"] > MELLUM_TOL:
            raise AssertionError(f"phase 17 window prefill: {case}")
    return out


def mellum_engine_case(layers=4, steps=16):
    """A Mellum2 of ``layers`` layers at its widths through
    ``ContinuousBatchingEngine`` under ``eager()``: two prompts that
    cross the window in one prefill tick, then one burst of ``steps``
    decode steps; each kernel's launches and the experts read."""
    from quest_tpu_torch.config import (QuestConfig, WINDOW,
                                        mellum2_12b_a2_5b)
    from quest_tpu_torch.engine import ContinuousBatchingEngine, Request
    from quest_tpu_torch.engine.graphs import eager, launch_counters
    from quest_tpu_torch.models.llama import init_params
    from quest_tpu_torch.utils.trace import RECORDER
    full = mellum2_12b_a2_5b()
    cfg = dataclasses.replace(full, num_layers=layers,
                              layer_types=full.layer_types[:layers])
    quest = QuestConfig(page_size=16, token_budget=2048, max_seq_len=8192,
                        skip_layers=2, block_pages=64,
                        kv_dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         dtype=torch.bfloat16, device="cuda")
    Lw = sum(t == WINDOW for t in cfg.layer_types)
    counters = {k.__name__: k for k in launch_counters()}
    rng = np.random.default_rng(17)
    reqs = [Request(i, rng.integers(1, cfg.vocab_size, n).tolist(), 64)
            for i, n in enumerate((1500, 1100))]
    with eager():
        eng = ContinuousBatchingEngine(cfg, quest, params, max_batch=2,
                                       prefill_bucket=256, burst=steps,
                                       prefill_chunk=4096, device="cuda")
        for r in reqs:
            eng.submit(r)
        ticks = []
        for kind in ("prefill", "decode"):
            for k in counters.values():
                k.launches = 0
            eng.step()
            torch.cuda.synchronize()
            tick = RECORDER.spans("tick")[-1].attrs
            got = {n: k.launches for n, k in counters.items() if k.launches}
            ticks.append(dict(kind=tick.get("kind"), steps=tick.get("steps"),
                              experts_read=tick.get("experts_read"),
                              window_blocks=tick.get("window_blocks"),
                              launches=got))
    log(f"  mellum engine ({layers} layers, {Lw} window): {ticks}")
    pre, dec = ticks
    n = dec["steps"]
    want_pre = dict(moe_route=layers, prefill_attention=layers)
    want_dec = dict(moe_route=layers * n, moe_experts=layers * n)
    bad = [(name, t["launches"].get(name, 0), v)
           for t, w in ((pre, want_pre), (dec, want_dec))
           for name, v in w.items() if t["launches"].get(name, 0) != v]
    if pre["kind"] != "prefill" or dec["kind"] != "decode" or not n:
        bad.append(("ticks", pre["kind"], dec["kind"], n))
    if pre["launches"].get("moe_experts") or (
            dec["launches"].get("dense_decode_attention", 0) < Lw * n):
        bad.append(("paths", pre["launches"], dec["launches"]))
    # Each step reads at least one expert a layer and at most all of them.
    if not layers * n <= (dec["experts_read"] or 0) <= layers * n * 64:
        bad.append(("experts_read", dec["experts_read"]))
    if bad:
        raise AssertionError(f"phase 17 engine: {bad}")
    del eng, params
    torch.cuda.empty_cache()
    return ticks


def mellum_phase():
    t0 = time.time()
    gen = torch.Generator(device="cuda").manual_seed(17)
    res = dict(moe=[moe_case(gen, r) for r in (1, 8, 512)],
               window=window_cases(gen),
               engine=mellum_engine_case())
    log(f"phase 17 (Mellum2) took {time.time() - t0:.1f} s")
    return res


def kernel_wrappers():
    """Each kernel's wrapper, which counts its launches."""
    from quest_tpu_torch.kv.paged_kv import (append_decode_at,
                                             append_prefill_at,
                                             rope_append_decode_at)
    from quest_tpu_torch.ops.copy_probe import copy_probe
    from quest_tpu_torch.ops.dense_decode import dense_decode_attention
    from quest_tpu_torch.ops.estimate import page_scores_physical
    from quest_tpu_torch.ops.fused_decode import (exact_topk_select,
                                                  fused_sparse_decode)
    from quest_tpu_torch.ops.head_gemv import head_gemv
    from quest_tpu_torch.ops.prefill import prefill_attention
    from quest_tpu_torch.ops.qdot import dequant, qgemv
    from quest_tpu_torch.ops.rms_norm import rms_norm
    from quest_tpu_torch.ops.rope import rotate_qk
    from quest_tpu_torch.ops.select_pieces import select_pieces
    from quest_tpu_torch.ops.silu_mul import silu_mul
    from quest_tpu_torch.ops.sparse_decode import sparse_decode_attention
    return {"sparse_decode": sparse_decode_attention,
            "dense_decode": dense_decode_attention,
            "prefill": prefill_attention, "estimate": page_scores_physical,
            "topk_select": exact_topk_select,
            "fused_decode": fused_sparse_decode,
            "copy_probe": copy_probe, "select_pieces": select_pieces,
            "qgemv": qgemv, "dequant": dequant,
            "append_decode": append_decode_at, "rope": rotate_qk,
            "rope_append": rope_append_decode_at, "rms_norm": rms_norm,
            "head_gemv": head_gemv, "append_prefill": append_prefill_at,
            "silu_mul": silu_mul}


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs only on the card", file=sys.stderr)
        return 1
    import quest_tpu_torch  # noqa: F401  (fails outside the checkout)
    from quest_tpu_torch.config import llama31_8b
    from quest_tpu_torch.utils.benchmarking import Timer

    name, smi = device_phase()
    logs = build_phase()
    if sys.argv[1:] == ["mellum"]:
        print(json.dumps({"mellum": mellum_phase()}))
        return 0
    ptxas = ptxas_kernels(logs.get("qgemv", ""))
    torch.manual_seed(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer()
    selection = selection_cases(timer, gen,
                                ptxas_kernels(logs.get("estimate", "")))
    results = {"sparse_decode": sparse_cases(timer, gen),
               "dense_decode": dense_cases(timer, gen),
               "prefill": prefill_cases(timer, gen),
               **fused_slice_cases(timer, gen),
               **layer_op_cases(timer, gen),
               **norm_head_cases(timer, gen),
               **prefill_mlp_cases(timer, gen)}
    for kname, cases in selection.items():      # the main path's first
        results[kname] = cases + results[kname]
    for kname, cases in fp8_cases(timer, gen).items():
        results[kname] += cases
    group = group_cases(timer, gen)
    for kname in ("sparse_decode", "dense_decode", "estimate",
                  "fused_decode", "prefill"):
        results[kname] += group.pop(kname)
    probe_results, probe_launches, copy_gbps = probe_phase(timer)
    results.update(probe_results)
    del timer
    torch.cuda.empty_cache()
    reference = {"bf16": small_reference_phase(torch.bfloat16),
                 "f32": small_reference_phase(torch.float32, F32_TOL),
                 "bf16_fused": small_reference_phase(torch.bfloat16,
                                                     fused=True),
                 "f32_fused": small_reference_phase(torch.float32, F32_TOL,
                                                    fused=True),
                 "serving_bf16_kv": small_reference_phase(
                     torch.float32, serving_kv=torch.bfloat16),
                 "serving_fp8_kv": small_reference_phase(
                     torch.float32, serving_kv=torch.float8_e4m3fn)}
    taps = []
    for fused in (False, True):
        for kv in (torch.float32, torch.bfloat16):
            res, cases = small_scheduler_phase(fused, kv)
            reference[f"scheduler_{'fused' if fused else 'unfused'}_"
                      f"{str(kv).split('.')[-1]}_kv"] = res
            taps.append(cases)
    counts, serving, params = serving_phase(kernel_wrappers(), smi)
    torch.cuda.empty_cache()
    serving["scheduler"], cases = scheduler_phase(params, kernel_wrappers(),
                                                  smi)
    taps.append(cases)
    for cases in taps:              # the scheduler's batches, as cases
        for kname, c in cases.items():
            results[kname] += c
    torch.cuda.empty_cache()
    timer = Timer()
    results.update(weight_kernel_phase(timer, gen, ptxas))
    for kname, cases in group.items():      # qgemv, dequant at out 1000
        results[kname] += cases
    del timer
    torch.cuda.empty_cache()
    for bits in (8, 4):
        reference[f"f32_int{bits}_weights"] = small_reference_phase(
            torch.float32, F32_TOL, bits=bits)
    reference["awq_int4_held_out_mse"] = small_awq_phase()
    serving["quantized"], quant_counts = quantized_serving_phase(
        params, kernel_wrappers(), smi)
    torch.cuda.empty_cache()
    serving["loader"] = loader_phase(params)
    torch.cuda.empty_cache()
    serving["evals"] = eval_phase(llama31_8b(), params, kernel_wrappers())
    torch.cuda.empty_cache()
    serving["tools"] = tools_phase(params, kernel_wrappers(), smi)
    torch.cuda.empty_cache()
    t15 = time.time()
    serving["multi_gpu"] = {"15a": world1_phase(params, kernel_wrappers())}
    del params
    torch.cuda.empty_cache()
    serving["multi_gpu"].update(multi_rank_phase(kernel_wrappers()))
    log(f"phase 15 took {time.time() - t15:.1f} s")
    serving["mellum"] = mellum_phase()

    kernels = []
    for kname, (src, rep, path) in KERNEL_META.items():
        cases = results[kname]
        head = cases[0]
        launches = (probe_launches[kname] if path == "probe"
                    else quant_counts[kname] if path == "quantized"
                    else tool_launches(serving["tools"], kname)
                    if path == "tools"
                    else counts[(path or "fused", "generate")][kname])
        by_path = {p: counts[(p, "generate")][kname] for p in SERVING_PATHS}
        kernels.append(dict(
            name=kname, route="cuda", source=src, replaces=rep,
            **({"also_replaces": ALSO_REPLACES[kname]}
               if kname in ALSO_REPLACES else {}),
            launches=launches, launches_by_serving_path=by_path,
            launches_scheduler=serving["scheduler"]["launches"][kname],
            main_path=("quantized int8 engine (generate_ondevice)"
                       if path == "quantized" else
                       "bench_kernels' append stage (phase 14); the decode "
                       "step runs its device code as rope_append"
                       if path == "tools" else path
                       or "none: its device code runs inside fused_decode"),
            max_abs_err=head["max_abs_err"],
            max_rel_err=max(c["max_rel_err"] for c in cases),
            ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=head["library_ms"], cases=cases))
    log(json.dumps({"device": name, "nvidia_smi": smi, "serving": serving,
                    "reference_rel_err": reference,
                    "copy_probe_gbps": copy_gbps}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
