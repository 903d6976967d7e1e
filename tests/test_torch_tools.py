"""The port's tools (``quest_tpu_torch/scripts``) against the JAX package's
scripts (``scripts/*.py``, loaded by path), on the CPU at tiny sizes:
accuracy_proxies row for row; accuracy_delta and the two examples over
the same numpy weights (greedy tokens, agreement and first divergence
equal, perplexity within 1e-4 relative); bench_serving's weight-free
fields; bench_textgen's and bench_kernels' JSON keys and bench_kernels'
byte and FLOP counts held to the JAX script's own formulas; and the
model's trace ranges under a profiler."""

import ast
import contextlib
import dataclasses
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from quest_tpu_torch.config import QuestConfig, tiny_test_model
from quest_tpu_torch.engine import QuestEngine
from quest_tpu_torch.kv.paged_kv import init_cache
from quest_tpu_torch.models.convert import params_from_numpy
from quest_tpu_torch.models.llama import (TRACE_RANGES, QuestModel,
                                          init_params, trace_range)
from quest_tpu_torch.scripts import (accuracy_delta, accuracy_proxies,
                                     bench_kernels, bench_serving,
                                     bench_textgen, example_demo,
                                     example_textgen, profile_textgen)
from quest_tpu_torch.utils.cli import ByteTokenizer

REPO = Path(__file__).resolve().parents[1]

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def jax_script(name, monkeypatch, tmp_path):
    """The JAX package's ``scripts/<name>.py`` as a module, with its
    compilation cache under ``tmp_path``."""
    pytest.importorskip("jax")
    monkeypatch.setenv("QUEST_JAX_CACHE", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(mod, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [mod.__name__] + argv)
    return mod.main()


# ---------------------------------------------------------------------------
# accuracy_proxies
# ---------------------------------------------------------------------------

def test_accuracy_proxies_match_jax(monkeypatch, tmp_path, capsys):
    argv = ["--ctx", "2048", "--heads", "2", "--seeds", "1"]
    run_jax_main(jax_script("accuracy_proxies", monkeypatch, tmp_path),
                 argv + ["--out", str(tmp_path / "jax.json")], monkeypatch)
    want = json.loads((tmp_path / "jax.json").read_text())
    got = accuracy_proxies.main(argv + ["--device", "cpu", "--out",
                                        str(tmp_path / "port.json")])
    assert json.loads((tmp_path / "port.json").read_text()) == got
    assert got.keys() == want.keys()
    for key in ("config_rows", "kernel_vs_sim", "gqa_rows", "passkey_rows"):
        assert len(got[key]) == len(want[key]) > 0, key
        for g, w in zip(got[key], want[key]):
            assert g.keys() == w.keys()
            for f, wv in w.items():
                if isinstance(wv, float):
                    assert abs(g[f] - wv) <= 1e-3, (key, f, g, w)
                else:
                    assert g[f] == wv, (key, f, g, w)
    assert "passkey end-task proxy" in capsys.readouterr().out


def test_accuracy_proxies_default_out_is_build():
    assert accuracy_proxies.parse_args([]).out.startswith("build/")


# ---------------------------------------------------------------------------
# accuracy_delta and the examples: both scripts over the same weights.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def same_weights():
    """build_engine stand-ins for both packages: the tiny preset (vocab
    259, 4 layers) in f32 over one set of numpy weights."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from quest_tpu import config as jconfig
    from quest_tpu.engine.engine import QuestEngine as JEngine
    from quest_tpu.models.llama import init_params as jinit
    from quest_tpu.utils.cli import ByteTokenizer as JTok
    jcfg = dataclasses.replace(jconfig.tiny_test_model(), vocab_size=259,
                               dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jinit(jcfg, jax.random.PRNGKey(0),
                                            dtype=jnp.float32))
    cfg = dataclasses.replace(tiny_test_model(), vocab_size=259,
                              dtype=torch.float32)
    tparams = params_from_numpy(params, device="cpu")

    def quest_kw(args):
        return dict(page_size=args.page_size, token_budget=args.token_budget,
                    max_seq_len=args.max_seq_len or 4096,
                    skip_layers=args.skip_layers)

    def jax_build(args):
        quest = jconfig.QuestConfig(kv_dtype=jnp.float32, **quest_kw(args))
        return JEngine(jcfg, quest, params, batch_size=args.batch), JTok()

    def port_build(args):
        quest = QuestConfig(kv_dtype=torch.float32, **quest_kw(args))
        return (QuestEngine(cfg, quest, tparams, batch_size=args.batch,
                            device="cpu"), ByteTokenizer())

    return jax_build, port_build


TINY = ["--random", "--preset", "tiny", "--layers", "4", "--skip-layers", "1"]


def test_accuracy_delta_matches_jax(same_weights, monkeypatch, tmp_path,
                                    capsys):
    jax_build, port_build = same_weights
    argv = TINY + ["--ctx", "256", "--eval-tokens", "16", "--gen-tokens",
                   "8", "--budgets", "64"]
    jmod = jax_script("accuracy_delta", monkeypatch, tmp_path)
    monkeypatch.setattr(jmod, "build_engine", jax_build)
    run_jax_main(jmod, argv + ["--cpu", "--json-out",
                               str(tmp_path / "jax.json")], monkeypatch)
    want = json.loads((tmp_path / "jax.json").read_text())
    monkeypatch.setattr(accuracy_delta, "build_engine", port_build)
    got = accuracy_delta.main(argv + ["--device", "cpu"])
    assert got.keys() == want.keys()
    assert [r["budget"] for r in got["rows"]] == [r["budget"]
                                                   for r in want["rows"]]
    assert got["rows"][0]["delta_ppl"] == 0.0
    for g, w in zip(got["rows"], want["rows"]):
        assert g.keys() == w.keys()
        assert g["gen_agree"] == w["gen_agree"], (g, w)
        assert g["first_divergence"] == w["first_divergence"], (g, w)
        assert abs(g["ppl"] - w["ppl"]) <= 1e-4 * w["ppl"], (g, w)
    # The sparse row really differs from the control (sparsity engaged).
    assert got["rows"][1]["mean_abs_delta_nll"] > 0
    assert "budget" in capsys.readouterr().out


def test_accuracy_delta_refuses_dense_only_runs():
    args = accuracy_delta.parse_args(TINY[:5] + ["--skip-layers", "4",
                                                 "--device", "cpu"])
    with pytest.raises(SystemExit, match="no layer runs sparse"):
        accuracy_delta.run_accuracy_delta(args)


def test_make_stream_matches_jax(monkeypatch, tmp_path):
    jmod = jax_script("accuracy_delta", monkeypatch, tmp_path)
    for seed in (0, 3):
        assert accuracy_delta.make_stream(259, 700, seed) == \
            jmod.make_stream(259, 700, seed)


def test_example_textgen_matches_jax(same_weights, monkeypatch, tmp_path,
                                     capsys):
    jax_build, port_build = same_weights
    argv = TINY + ["--max-new-tokens", "12", "--max-seq-len", "512",
                   "--token-budget", "64"]
    jmod = jax_script("example_textgen", monkeypatch, tmp_path)
    monkeypatch.setattr(jmod, "build_engine", jax_build)
    run_jax_main(jmod, argv + ["--cpu"], monkeypatch)
    want = capsys.readouterr().out
    monkeypatch.setattr(example_textgen, "build_engine", port_build)
    got = example_textgen.main(argv + ["--device", "cpu"])
    assert len(got["tokens"]) == 12
    assert capsys.readouterr().out == want == got["text"] + "\n"


def test_example_demo_matches_jax(same_weights, monkeypatch, tmp_path,
                                  capsys):
    jax_build, port_build = same_weights
    argv = TINY + ["--max-new-tokens", "10", "--token-budget", "32",
                   "--max-seq-len", "512", "--prompt", "abcdefgh" * 12]
    jmod = jax_script("example_demo", monkeypatch, tmp_path)
    monkeypatch.setattr(jmod, "build_engine", jax_build)
    run_jax_main(jmod, argv + ["--cpu"], monkeypatch)
    want = capsys.readouterr().out
    monkeypatch.setattr(example_demo, "build_engine", port_build)
    got = example_demo.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out

    def texts(s):
        """The printed lines without the times."""
        return [ln.split(";")[0] if ln.startswith("token agreement") else ln
                for ln in s.splitlines() if not ln.startswith("===")]

    assert texts(out) == texts(want)
    tok = ByteTokenizer()
    assert texts(out)[:2] == [tok.decode(got["quest_tokens"]),
                              tok.decode(got["full_tokens"])]
    assert got["agreement"] == sum(a == b for a, b in zip(
        got["quest_tokens"], got["full_tokens"]))


# ---------------------------------------------------------------------------
# bench_serving, bench_textgen, bench_kernels, profile_textgen
# ---------------------------------------------------------------------------

SERVING = ["--preset", "tiny", "--layers", "2", "--max-batch", "2",
           "--requests", "4", "--prompt-len", "64", "--gen-len", "3",
           "--max-seq-len", "256", "--block-pages", "2", "--shared-prefix",
           "40", "--ab-rounds", "1"]


def test_bench_serving_matches_jax(monkeypatch, tmp_path, capsys):
    run_jax_main(jax_script("bench_serving", monkeypatch, tmp_path),
                 SERVING + ["--cpu"], monkeypatch)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    (got,) = bench_serving.main(SERVING + ["--device", "cpu"])
    assert got.keys() == want.keys()
    for f in ("generated_tokens", "prefix_hits", "prefix_hit_tokens",
              "shared_blocks", "block_tokens"):
        assert got[f] == want[f], (f, got, want)
    assert got["prefix_hits"] > 0 and got["generated_tokens"] == 4 * 3
    assert json.loads(capsys.readouterr().out) == got


def jax_source(name):
    return ast.parse((REPO / "scripts" / f"{name}.py").read_text())


def jax_result_keys(tree):
    """Keys of bench_textgen's ``result`` dict: its literal and its later
    ``result[...] = ...`` assignments."""
    keys = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                        ast.Name)
                and node.targets[0].id == "result"
                and isinstance(node.value, ast.Dict)):
            keys += [k.value for k in node.value.keys]
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].value, ast.Name)
                and node.targets[0].value.id == "result"):
            keys.append(node.targets[0].slice.value)
    return keys


@pytest.mark.parametrize("ab_full", [False, True])
def test_bench_textgen_keys_match_jax(ab_full, capsys):
    argv = ["--model", "tiny", "--layers", "2", "--skip-layers", "1",
            "--ctx", "512", "--budget", "128", "--decode-tokens", "4",
            "--burst", "2", "--device", "cpu"] + (["--ab-full"] if ab_full
                                                  else [])
    got = bench_textgen.main(argv)
    keys = jax_result_keys(jax_source("bench_textgen"))
    assert list(got) == (keys if ab_full else keys[:-2])
    assert json.loads(capsys.readouterr().out) == got
    assert got["ctx"] == 512 and got["layers"] == 2
    if ab_full:
        assert got["full_cache_ms_per_token"] > 0


def jax_stage_formulas(env):
    """bench_kernels' byte counts a stage and the prefill FLOPs,
    evaluated from the JAX script's own expressions over ``env``."""
    tree = jax_source("bench_kernels")
    env = dict(env)
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                        ast.Name)
                and node.targets[0].id in ("meta_bytes", "pages_bytes",
                                           "dense_bytes", "flops", "bpe")):
            env[node.targets[0].id] = eval(ast.unparse(node.value), {}, env)
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "report"):
            out[node.args[0].value] = eval(ast.unparse(node.args[2]), {}, env)
    out["prefill"] = env["flops"]
    return out


def test_bench_kernels_matches_jax_accounting(capsys):
    pytest.importorskip("jax")
    from quest_tpu.config import QuestConfig as JQuest
    argv = ["--ctx", "1024", "--budget", "128", "--heads", "4",
            "--kv-heads", "2", "--iters", "2", "--device", "cpu"]
    detail = {}
    got = bench_kernels.run_bench_kernels(bench_kernels.parse_args(argv),
                                          detail)
    jq = JQuest(page_size=16, token_budget=128, max_seq_len=1024)
    want = jax_stage_formulas(dict(B=1, Hq=4, Hkv=2, D=128, page=16,
                                   CTX=1024, P=jq.max_pages,
                                   S=jq.page_budget, CHUNK=1024))
    assert set(got) == set(want)
    assert all(v > 0 for v in got.values())
    for name, row in detail.items():
        assert row.get("flops", row.get("bytes")) == want[name], name
        assert row["calls"] == 2 + bench_kernels.WARMUP
        assert row["launches"] == 0                  # the plain versions
    assert bench_kernels.main(argv + ["--stages", "topk,append"]).keys() == {
        "topk", "append_decode"}
    assert '"append_decode"' in capsys.readouterr().out


def test_bench_kernels_refuses_unknown_stage():
    with pytest.raises(SystemExit, match="unknown stages"):
        bench_kernels.main(["--stages", "estimate,bogus", "--device", "cpu",
                            "--ctx", "256", "--budget", "64"])


def test_profile_textgen_runs(tmp_path, capsys):
    out = profile_textgen.main(["--preset", "tiny", "--layers", "3",
                                "--ctx", "256", "--decode-tokens", "2",
                                "--token-budget", "64", "--device", "cpu",
                                "--trace-dir", str(tmp_path)])
    want = set(TRACE_RANGES) - {"quest_fused_decode"}
    assert set(out["ranges"]) == want
    # One traced pass: prefill (3 layers) and two decode steps.
    assert out["ranges"]["prefill_attn"]["calls"] == 3
    assert out["ranges"]["append_kv_decode"]["calls"] == 6
    assert out["ranges"]["quest_sparse_attn"]["calls"] == 2
    assert all(r["host_ms"] > 0 for r in out["ranges"].values())
    trace = json.loads(Path(out["trace"]).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert want <= names
    assert "mlp" in capsys.readouterr().out


def test_tools_default_to_the_card():
    for mod in (bench_kernels, bench_textgen, bench_serving,
                profile_textgen, accuracy_delta, accuracy_proxies,
                example_textgen, example_demo):
        args = mod.parse_args(["--random"] if mod in (
            accuracy_delta, example_textgen, example_demo) else [])
        assert args.device == "cuda", mod.__name__
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            bench_kernels.main(["--ctx", "256", "--budget", "64"])


# ---------------------------------------------------------------------------
# The model's trace ranges.
# ---------------------------------------------------------------------------

def recorded_ranges(fused):
    """The trace ranges a profiler records over one prefill and one decode
    step of a tiny 3-layer model (skip_layers 1)."""
    from torch.profiler import ProfilerActivity, profile
    cfg = dataclasses.replace(tiny_test_model(), num_layers=3,
                              dtype=torch.float32)
    quest = QuestConfig(page_size=16, token_budget=64, max_seq_len=2048,
                        skip_layers=1, kv_dtype=torch.float32,
                        fused_decode=fused)
    model = QuestModel(cfg, quest, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    cache = init_cache(cfg, quest, batch_size=1, device="cpu")
    tokens = torch.arange(1, 101, dtype=torch.int32)[None]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.prefill_last(cache, tokens)
        model.decode_token_step(cache, torch.tensor([5], dtype=torch.int32))
    calls = {}
    for e in prof.events():
        if e.name in TRACE_RANGES:
            calls[e.name] = calls.get(e.name, 0) + 1
    return calls


@pytest.mark.parametrize("fused", [False, True])
def test_trace_ranges_recorded(fused):
    calls = recorded_ranges(fused)
    per_layer = {"qkv_proj": 2, "rope": 2, "o_proj": 2, "mlp": 2,
                 "append_kv_prefill": 1, "prefill_attn": 1,
                 "append_kv_decode": 1}
    want = {k: 3 * n for k, n in per_layer.items()}
    want["dense_decode_attn"] = 1
    if fused:
        want["quest_fused_decode"] = 2
    else:
        want.update(quest_estimate=2, quest_topk=2, quest_sparse_attn=2)
    assert calls == want


def test_trace_range_is_free_without_a_profiler(monkeypatch):
    assert isinstance(trace_range("mlp"), contextlib.nullcontext)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built unprofiled")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    cfg = dataclasses.replace(tiny_test_model(), num_layers=3)
    quest = QuestConfig(max_seq_len=256, skip_layers=1)
    model = QuestModel(cfg, quest, init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    cache = init_cache(cfg, quest, batch_size=1, device="cpu")
    model.prefill_last(cache, torch.arange(1, 40, dtype=torch.int32)[None])
    tok = model.decode_token_step(cache, torch.tensor([5], dtype=torch.int32))
    assert tok.shape == (1,)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="built unprofiled"):
            model.decode_token_step(cache, tok)


# ---------------------------------------------------------------------------
# On the card.
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (sm_90a) and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [False, True])
def test_profile_textgen_ranges_on_card(cuda, fused, tmp_path, monkeypatch):
    """Every range of the path holds device time, the kernels launched
    through their C entry points included."""
    from quest_tpu_torch.config import small_tpu_model
    cfg = dataclasses.replace(small_tpu_model(), num_layers=4, num_heads=8,
                              num_kv_heads=2)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    if fused:
        real = QuestConfig.__init__

        def fused_config(self, *a, **kw):
            real(self, *a, fused_decode=True, **kw)
        monkeypatch.setattr(QuestConfig, "__init__", fused_config)
    args = profile_textgen.parse_args(
        ["--ctx", "2048", "--decode-tokens", "3", "--token-budget", "256",
         "--trace-dir", str(tmp_path)])
    out = profile_textgen.run_profile_textgen(cfg, params, args)
    path = {"quest_fused_decode"} if fused else {
        "quest_estimate", "quest_topk", "quest_sparse_attn"}
    want = set(TRACE_RANGES) - {"quest_fused_decode", "quest_estimate",
                                "quest_topk", "quest_sparse_attn"} | path
    assert set(out["ranges"]) == want
    for name, r in out["ranges"].items():
        assert r["calls"] > 0 and 0 < r["device_ms"] <= r["span_ms"] + 1e-6, (
            name, r)


@pytest.mark.cuda
def test_bench_kernels_launches_on_card(cuda):
    detail = {}
    out = bench_kernels.run_bench_kernels(bench_kernels.parse_args(
        ["--ctx", "4096", "--budget", "512", "--kv-heads", "8", "--iters",
         "3"]), detail)
    assert set(out) == set(bench_kernels.RESULT_KEYS.values())
    for name, row in detail.items():
        assert row["launches"] == (row["calls"] if row["kernel"] else 0), row
        assert row.get("gbps", 0) <= 3350 and row.get("tflops", 0) <= 989
