"""Interpretable accuracy proxies for Quest's page selection (counterpart
of ``scripts/accuracy_proxies.py``).

With no checkpoint, the selection mechanism itself is measured on
structured, low-entropy inputs, the regime of the paper's accuracy claims
(attention concentrated on a few positions):

  inputs   keys follow an AR(1) drifting mean (pages internally coherent,
           like real K caches) plus ``n_needles`` positions whose keys
           align with the query (the passkey-style signal);
  metrics  per (regime, page size, token budget, storage dtypes):
    mass_coverage   share of the full attention distribution inside the
                    selected pages (1.0 = lossless)
    needle_recall   share of needle tokens inside selected pages
    oracle_overlap  |selected ∩ true top-K pages| / K
    out_rel_err     relative L2 error of sparse vs dense attention out
    rand_coverage   the mass a random selection of that size captures
  plus GQA coverage (one page set a KV head for G query heads), the
  kernel path's selection against the simulated attention
  (``evals/sim_attention.py``), and a passkey-style retrieval proxy
  through the simulation at pages of 16 and 32.

The selection runs through the port's ``page_scores``,
``page_scores_per_qhead``, ``select_pages`` and ``quest_sim_attention``
on ``--device``; the inputs and the metrics are numpy f32 on the host,
from fixed seeds. Writes one JSON (``--out``).

    python -m quest_tpu_torch.scripts.accuracy_proxies [--ctx 16384]
    python -m quest_tpu_torch.scripts.accuracy_proxies --device cpu \\
        --ctx 2048 --heads 2 --seeds 1                          # smoke
"""

from __future__ import annotations

import argparse
import collections
import json
import os

import numpy as np
import torch

# Four attention regimes:
#   diffuse  needles ~3 sigma over an AR(1) background: mass spread over
#            thousands of tokens, where any budget must lose mass;
#   peaked   needles ~7 sigma: retrieval-style concentrated attention;
#   flat     no needles: the flattest, summarization-like scores;
#   multi    32 needles at ~4.5 sigma: multi-needle retrieval.
REGIMES = {"diffuse": dict(needle_gain=3.0, rho=0.98),
           "peaked": dict(needle_gain=7.0, rho=0.98),
           "flat": dict(n_needles=0, rho=0.98),
           "multi": dict(n_needles=32, needle_gain=4.5, rho=0.98)}
# Storage dtypes (KV data, metadata): production bf16, the fp8-metadata
# serving config, and fp8 KV (metadata folded from the stored keys).
DTYPES = {"bf16": (torch.bfloat16, torch.bfloat16),
          "fp8meta": (torch.bfloat16, torch.float8_e4m3fn),
          "fp8kv": (torch.float8_e4m3fn, torch.float8_e4m3fn)}


def structured_kv(rng, H, T, D, n_needles=8, needle_gain=3.0, rho=0.98):
    """Low-entropy K/V: AR(1) drifting mean + noise, plus needle keys
    aligned with the (returned) query. Returns q [H,D], k/v [H,T,D],
    needle positions [n_needles]."""
    q = rng.standard_normal((H, D)).astype(np.float32)
    drift = np.zeros((H, T, D), np.float32)
    eta = rng.standard_normal((H, T, D)).astype(np.float32)
    drift[:, 0] = eta[:, 0]
    a = np.sqrt(1.0 - rho * rho)
    for t in range(1, T):
        drift[:, t] = rho * drift[:, t - 1] + a * eta[:, t]
    k = 0.7 * drift + 0.5 * rng.standard_normal((H, T, D)).astype(np.float32)
    v = rng.standard_normal((H, T, D)).astype(np.float32)
    needles = (rng.choice(T - 64, size=n_needles, replace=False)
               if n_needles else np.zeros((0,), np.int64))
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    for pos in needles:
        k[:, pos] = needle_gain * qn + 0.2 * rng.standard_normal(
            (H, D)).astype(np.float32)
    return q, k, v, np.sort(needles)


def full_attention(q, k, v, sm):
    s = np.einsum("hd,htd->ht", q, k) * sm
    s -= s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(axis=-1, keepdims=True)
    out = np.einsum("ht,htd->hd", p, v)
    return p, out


def cast(x, dtype):
    """``x`` stored in ``dtype`` and read back as f32 (host)."""
    return torch.from_numpy(x).to(dtype).float().numpy()


def masked_attention(q, k, v, keep, sm):
    s = np.einsum("hd,htd->ht", q, k) * sm
    s = np.where(keep, s, -1e30)
    s -= s.max(axis=-1, keepdims=True)
    p = np.exp(s)
    p /= p.sum(axis=-1, keepdims=True)
    return np.einsum("ht,htd->hd", p, v)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ctx", type=int, default=16384)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--out", default="build/accuracy_proxies.json")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def run_accuracy_proxies(args) -> dict:
    """The proxies of ``args`` (see :func:`parse_args`); returns the JSON
    dict (also written to ``args.out``)."""
    from quest_tpu_torch.evals.sim_attention import quest_sim_attention
    from quest_tpu_torch.ops.estimate import page_scores, page_scores_per_qhead
    from quest_tpu_torch.ops.topk import select_pages
    from quest_tpu_torch.ops.utils import resolve_device

    dev = resolve_device(args.device)
    H, T, D = args.heads, args.ctx, 128
    sm = 1.0 / np.sqrt(D)
    seq = torch.tensor([T], dtype=torch.int32, device=dev)

    def on(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def select(scores, page, K):
        """select_pages on the device -> (ids [H, K] numpy, num_valid)."""
        idx, nv = select_pages(scores, seq, page, K)
        return idx[0].cpu().numpy(), int(nv[0])

    def sim(q, k, v, budget, chunk):
        return quest_sim_attention(on(q[None]), on(k[None]), on(v[None]),
                                   token_budget=budget, chunk_size=chunk,
                                   sm_scale=sm)[0].cpu().numpy()

    rows, sim_rows, gqa_rows = [], [], []
    for regime, rkw in REGIMES.items():
        for seed in range(args.seeds):
            rng = np.random.default_rng(100 + seed)
            q, k, v, needles = structured_kv(rng, H, T, D, **rkw)
            p_full, out_full = full_attention(q, k, v, sm)

            for page in (16, 32):
                P = T // page
                page_mass = p_full.reshape(H, P, page).sum(-1)    # [H, P]
                needle_pages = needles // page
                for budget in (512, 1024, 2048, 4096):
                    K = budget // page
                    for dtname, (kv_dt, meta_dt) in DTYPES.items():
                        ks = cast(k, kv_dt)       # stored K (read back)
                        vs = cast(v, kv_dt)
                        kp = ks.reshape(H, P, page, D)
                        km = cast(kp.max(axis=2), meta_dt)[None]
                        kn = cast(kp.min(axis=2), meta_dt)[None]
                        scores = page_scores_per_qhead(on(q[None]), on(km),
                                                       on(kn))  # [1, H, P]
                        idx, nv = select(scores, page, K)
                        sel = np.zeros((H, P), bool)
                        for h in range(H):
                            sel[h, idx[h, :nv]] = True

                        cov = (page_mass * sel).sum(-1).mean()
                        # Random-selection floor: K/P of the mass.
                        rand_cov = min(1.0, K / P)
                        nrec = (float(np.mean([sel[:, pg].mean()
                                               for pg in needle_pages]))
                                if len(needle_pages) else 1.0)
                        oracle = np.argsort(-page_mass, axis=-1)[:, :K]
                        ov = np.mean([len(set(oracle[h]) & set(idx[h, :nv]))
                                      / K for h in range(H)])
                        # Sparse output over the stored K/V against the
                        # f32 full-cache truth; the dense error over the
                        # stored K/V is the dtype's own floor.
                        keep = np.repeat(sel, page, axis=1)   # [H, T]
                        out = masked_attention(q, ks, vs, keep, sm)
                        err = (np.linalg.norm(out - out_full)
                               / np.linalg.norm(out_full))
                        outd = masked_attention(q, ks, vs,
                                                np.ones_like(keep), sm)
                        derr = (np.linalg.norm(outd - out_full)
                                / np.linalg.norm(out_full))
                        rows.append(dict(
                            regime=regime, seed=seed, page=page,
                            budget=budget, meta=dtname,
                            mass_coverage=round(float(cov), 4),
                            rand_coverage=round(rand_cov, 4),
                            needle_recall=round(nrec, 4),
                            oracle_overlap=round(float(ov), 4),
                            out_rel_err=round(float(err), 5),
                            dense_dtype_err=round(float(derr), 5)))

            # GQA: G query heads share one KV head; selection a KV head
            # with group_agg=sum (the engine default); coverage of each
            # query head against its own full-attention mass.
            for G in (4, 8):
                qg = np.stack([q + 0.35 * rng.standard_normal(
                    (H, D)).astype(np.float32) for _ in range(G)],
                    axis=1).reshape(H * G, D)        # [Hkv*G, D]
                pg_full, _ = full_attention(
                    qg, np.repeat(k, G, axis=0), np.repeat(v, G, axis=0), sm)
                for page in (16, 32):
                    P = T // page
                    kp = k.reshape(H, P, page, D)
                    K = 2048 // page
                    sc = page_scores(on(qg[None]), on(kp.max(axis=2)[None]),
                                     on(kp.min(axis=2)[None]),
                                     group_agg="sum")      # [1, Hkv, P]
                    idx, nv = select(sc, page, K)
                    mass = pg_full.reshape(H, G, P, page).sum(-1)
                    sel = np.zeros((H, P), bool)
                    for h in range(H):
                        sel[h, idx[h, :nv]] = True
                    cov = (mass * sel[:, None, :]).sum(-1).mean()
                    gqa_rows.append(dict(regime=regime, seed=seed, G=G,
                                         page=page, budget=2048,
                                         mass_coverage=round(float(cov), 4),
                                         rand_coverage=round(
                                             min(1.0, K / P), 4)))

            # Kernel path vs the simulation (the reference algorithm) on
            # the same inputs: per-query-head selection, chunk = page = 16.
            page, budget = 16, 2048
            P, K = T // page, 2048 // page
            kp = k.reshape(H, P, page, D)
            scores = page_scores_per_qhead(on(q[None]),
                                           on(kp.max(axis=2)[None]),
                                           on(kp.min(axis=2)[None]))
            idx, _ = select(scores, page, K)
            sim_out = sim(q, k, v, budget, page)
            # The simulation's kept chunks (its selection rule again).
            sign = np.where(q > 0, 1.0, -1.0)
            cmax = (k * sign[:, None, :]).reshape(H, P, page, D).max(axis=2)
            cscore = np.einsum("hd,hpd->hp", q * sign, cmax)
            k_chunks = min(max(3, budget // page), P)
            sim_sel = np.argsort(-cscore, axis=-1)[:, :k_chunks]
            ov = np.mean([len(set(sim_sel[h]) & set(idx[h])) / k_chunks
                          for h in range(H)])
            sel = np.zeros((H, P), bool)
            for h in range(H):
                sel[h, idx[h]] = True
            out = masked_attention(q, k, v, np.repeat(sel, page, axis=1), sm)
            sim_rows.append(dict(
                regime=regime, seed=seed,
                selection_overlap=round(float(ov), 4),
                out_rel_err_vs_sim=round(float(np.linalg.norm(out - sim_out)
                                         / np.linalg.norm(sim_out)), 5)))

    # Passkey-style end-task proxy through the simulation: an 8-token
    # "digit" (keys aligned with the question's query, values one of 10
    # random codes) at a depth, decoded at chunk 16 vs 32 at a matched
    # token budget; retrieval = the nearest code to the output (the
    # reference's passkey protocol, with the model replaced by a
    # directly checkable code).
    passkey_rows = []
    codes = np.random.default_rng(7).standard_normal((10, D)).astype(
        np.float32)
    codes /= np.linalg.norm(codes, axis=-1, keepdims=True)
    depths = (0.05, 0.3, 0.5, 0.7, 0.95)
    for chunk in (16, 32):
        for budget in (1024, 2048):
            n_ok = n_dense_ok = n_tot = 0
            for seed in range(args.seeds):
                for di, depth in enumerate(depths):
                    rng = np.random.default_rng(1000 + seed * 31 + di)
                    q, k, v, _ = structured_kv(rng, H, T, D, n_needles=0)
                    digit = int(rng.integers(0, 10))
                    pos = int(depth * (T - 64))
                    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
                    for j in range(8):
                        k[:, pos + j] = 6.0 * qn + 0.2 * rng.standard_normal(
                            (H, D)).astype(np.float32)
                        v[:, pos + j] = codes[digit]
                    out = sim(q, k, v, budget, chunk)
                    _, outd = full_attention(q, k, v, sm)
                    n_ok += int(np.argmax(codes @ out.mean(axis=0))) == digit
                    n_dense_ok += int(np.argmax(
                        codes @ outd.mean(axis=0))) == digit
                    n_tot += 1
            passkey_rows.append(dict(
                chunk=chunk, budget=budget, trials=n_tot,
                retrieval_acc=round(n_ok / n_tot, 4),
                dense_acc=round(n_dense_ok / n_tot, 4)))

    result = dict(ctx=T, heads=H, head_dim=D, config_rows=rows,
                  kernel_vs_sim=sim_rows, gqa_rows=gqa_rows,
                  passkey_rows=passkey_rows)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    summarize(result, args.seeds)
    return result


def summarize(result, seeds) -> None:
    """Prints the compact tables: means over seeds."""
    agg = collections.defaultdict(list)
    for r in result["config_rows"]:
        agg[(r["regime"], r["page"], r["budget"], r["meta"])].append(r)
    print(f"ctx={result['ctx']} heads={result['heads']} (mean over {seeds} "
          f"seeds)")
    print("regime  page budget meta  coverage (rand)  needle  oracle  "
          "out_err")
    for (regime, page, budget, meta), rs in sorted(agg.items()):
        m = {k: np.mean([r[k] for r in rs]) for k in
             ("mass_coverage", "rand_coverage", "needle_recall",
              "oracle_overlap", "out_rel_err")}
        print(f"{regime:7s} {page:4d} {budget:6d} {meta:4s}  "
              f"{m['mass_coverage']:.4f} ({m['rand_coverage']:.3f})  "
              f"{m['needle_recall']:.3f}   {m['oracle_overlap']:.3f}   "
              f"{m['out_rel_err']:.5f}")
    print("kernel vs sim:",
          [f"{r['regime']}: overlap={r['selection_overlap']:.3f} "
           f"err={r['out_rel_err_vs_sim']:.5f}"
           for r in result["kernel_vs_sim"]])
    gagg = collections.defaultdict(list)
    for r in result["gqa_rows"]:
        gagg[(r["G"], r["page"])].append(r["mass_coverage"])
    print("GQA per-kv-head selection coverage (budget 2048):",
          {f"G={g},p{p}": round(float(np.mean(v)), 4)
           for (g, p), v in sorted(gagg.items())})
    print("passkey end-task proxy (sim path):")
    for r in result["passkey_rows"]:
        print(f"  chunk={r['chunk']:2d} budget={r['budget']:4d}  "
              f"acc={r['retrieval_acc']:.3f} "
              f"(dense {r['dense_acc']:.3f}, n={r['trials']})")


def main(argv=None):
    return run_accuracy_proxies(parse_args(argv))


if __name__ == "__main__":
    main()
