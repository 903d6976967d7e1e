"""Where the estimate's physical route spends its time, on the card.

Usage: python -m quest_tpu_torch.exp.estimate_stages [--variants] [--sweep]
       python -m quest_tpu_torch.exp.estimate_stages --cpu

Builds ``csrc/estimate.cu`` as it stands and again with preprocessor
defines, and times ``ops/estimate.py:page_scores_physical`` (the unfused
decode step's estimate, the source's physical route) on each build, the
builds in turns, under ``Timer(flush="read")`` and under the memset
flush (``utils/benchmarking.py``), at the main path's shapes:
Llama-3.1-8B attention (8 KV heads, G = 4, a bf16 query), 64-page blocks
under a shuffled block table; B=1 over 32768 and 131072 tokens (bf16
metadata, page 16); B=2 with rows of 5000 and 2500 tokens in a
16384-token table whose idle blocks sit on scratch block 0 and whose
rows share a block; fp8 e4m3 metadata at page 32 over 32768 tokens.
``--variants``: the ablation builds ``QT_EST_EMPTY`` (the launch alone),
``QT_EST_NO_TABLE`` (the rows read without the block table),
``QT_EST_NO_LOAD`` (the table read, no metadata row) and
``QT_EST_NO_MATH`` (the rows, no products). ``--sweep``: the builds
``QT_EST_STAGE_PAGES`` = 32 and 16 (at most that many pages a unit and a
ring stage, where the launch plan takes up to 128), each held to the
plain version within 1e-5 as the build as it stands is. The bound, the
plain version and the ``torch.bmm`` yardstick at these shapes are
``chip_smoke.py`` phase 3's. Prints one JSON line last.
``--cpu`` runs the plain version once on a small pool (a smoke run of
the script).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import torch

from quest_tpu_torch.config import QuestConfig, llama31_8b
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.estimate import (page_scores_physical,
                                          page_scores_physical_plain)
from quest_tpu_torch.ops.utils import resolve_device

VARIANTS = ("QT_EST_EMPTY", "QT_EST_NO_TABLE", "QT_EST_NO_LOAD",
            "QT_EST_NO_MATH")
STAGE_PAGES = (32, 16)
# (label, table tokens, row lengths, page, metadata dtype)
CASES = (
    ("B=1, 32768 tokens, bf16 page 16", 32768, (32768,), 16,
     torch.bfloat16),
    ("B=2, 5000+2500 tokens, bf16 page 16", 16384, (5000, 2500), 16,
     torch.bfloat16),
    ("B=1, 32768 tokens, fp8 page 32", 32768, (32768,), 32,
     torch.float8_e4m3fn),
    ("B=1, 131072 tokens, bf16 page 16", 131072, (131072,), 16,
     torch.bfloat16),
)


def make_case(device, max_seq_len, lens, page, meta_dtype, seed=0):
    """One layer of Llama-3.1-8B page metadata (random, keyed by physical
    page) under a shuffled block table; blocks past a row's length sit on
    scratch block 0 and row 1 starts on row 0's first block. Returns
    (q, k_max, k_min, block_tab)."""
    cfg = llama31_8b()
    quest = QuestConfig(max_seq_len=max_seq_len, page_size=page,
                        meta_dtype=meta_dtype)
    B = len(lens)
    cache = init_cache(cfg, quest, batch_size=B, num_layers=1, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    kmax = torch.randn(cache.k_max.shape[1:], generator=g, device=device)
    kmin = kmax - torch.rand(kmax.shape, generator=g, device=device)
    NPB, NB = kmax.shape[1], cache.block_tab.shape[1]
    perm = torch.randperm(NPB - 1, generator=torch.Generator().manual_seed(1))
    tab = (1 + perm[:B * NB]).reshape(B, NB).to(torch.int32)
    bt = cache.block_pages * page
    for b, n in enumerate(lens):
        tab[b, -(-n // bt):] = 0
    if B > 1:
        tab[1, 0] = tab[0, 0]
    q = torch.randn((B, cfg.num_heads, cfg.head_dim), generator=g,
                    device=device).to(torch.bfloat16)
    del cache
    return (q, kmax.to(meta_dtype), kmin.to(meta_dtype), tab.to(device))


def builds(argv):
    """{name: defines} of the builds that ``argv`` asks for, the source as
    it stands first."""
    out = {"kernel": ()}
    if "--variants" in argv:
        out.update({v[len("QT_EST_"):].lower(): (v,) for v in VARIANTS})
    if "--sweep" in argv:
        out.update({f"stage_pages_{sp}": (f"QT_EST_STAGE_PAGES={sp}",)
                    for sp in STAGE_PAGES})
    return out


def main(argv):
    cpu = "--cpu" in argv
    device = resolve_device("cpu" if cpu else "cuda")
    if cpu:
        q, kmax, kmin, tab = make_case(device, 2048, (1000, 500), 16,
                                       torch.bfloat16)
        s = page_scores_physical(q, kmax, kmin, tab)
        print(f"cpu: plain version, scores {tuple(s.shape)}, finite "
              f"{bool(torch.isfinite(s).all())}")
        return 0
    todo = builds(argv)
    if len(todo) == 1:
        print(__doc__, file=sys.stderr)
        return 2
    from quest_tpu_torch.utils.benchmarking import Timer, in_turns
    with ThreadPoolExecutor(len(todo)) as ex:
        list(ex.map(lambda d: _build.build(["estimate"], d), todo.values()))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    timers = {"read": Timer(flush="read"), "memset": Timer()}
    load = _build.load

    def on(defines, args):
        """page_scores_physical(*args) on the build of ``defines``."""
        with mock.patch.object(_build, "load",
                               lambda name, d=(): load(name, defines)):
            return page_scores_physical(*args)

    res = {"device": smi, "cases": []}
    for label, cap, lens, page, mdt in CASES:
        args = make_case(device, cap, lens, page, mdt)
        want = page_scores_physical_plain(*args)
        err = {}
        for name, d in todo.items():
            if d and d[0] in VARIANTS:
                continue            # an ablation computes something else
            got = on(d, args)
            err[name] = float((got - want).abs().max() / want.abs().max())
            assert err[name] <= 1e-5, (label, name, err[name])
        fns = {name: (lambda d=d: on(d, args)) for name, d in todo.items()}
        t = {k: in_turns(timer, fns) for k, timer in timers.items()}
        res["cases"].append(dict(case=label, max_rel_err=err, turns_ms=t))
        us = {k: {n: statistics.mean(x) * 1e3 for n, x in d.items()}
              for k, d in t.items()}
        print(f"{label}: rel err {max(err.values()):.1e}; us read / memset "
              "flush: " + "; ".join(f"{n} {us['read'][n]:.2f} / "
                                    f"{us['memset'][n]:.2f}" for n in todo),
              flush=True)
        del args, want
        torch.cuda.empty_cache()
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
