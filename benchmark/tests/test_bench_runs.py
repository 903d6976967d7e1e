"""Whole runs of the harness on the CPU's plain path, on a copy of the
benchmark with a tiny configuration (conftest.py): the check passes on
the program as it is, and fails with the timed path broken underneath in
each way a serving cell can break; the control (the reference in fp8)
reads far above the program. The harness's look for a card is skipped by
calling ``run_cell`` directly; ``main`` itself refuses to run here."""

from __future__ import annotations

import pytest
import torch

from bench.faults import planted

SEED = 2 ** 31 + 12345


def _run(run_module, here, workload, **kw):
    return run_module.run_cell(workload, SEED, 2.0, trace=False,
                               device="cpu", here=here, t0=0.0, **kw)


@pytest.mark.parametrize("workload", ["tiny-closed", "tiny-open"])
def test_run_is_correct_and_control_is_not(run_module, tiny_bench, workload):
    res, cmp, info = _run(run_module, tiny_bench, workload, control=True)
    assert res["correct"], (cmp, info)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert cmp["tokens_checked_at_least"]["value"] >= 20
    gap = cmp["logit_gap_mean"]["value"]
    # The control: the reference in fp8 puts other tokens first, far
    # beyond what the program's rounding does.
    assert info["control_mean_gap"] > max(3 * gap,
                                          cmp["logit_gap_mean"]["limit"])
    names = set(res["metrics"])
    assert "setup_s" in names
    assert ("output_tokens_per_s" in names) == (workload == "tiny-closed")
    assert ("tpot_p90_ms" in names) == (workload == "tiny-open")


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "token_altered", "select_first"])
def test_broken_timed_path_is_not_correct(run_module, tiny_bench, fault):
    with planted(fault):
        res, cmp, info = _run(run_module, tiny_bench, "tiny-closed")
    assert not res["correct"], (cmp, info)
    assert cmp["logit_gap_mean"]["value"] > cmp["logit_gap_mean"]["limit"]


def test_main_refuses_without_a_card(run_module, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: main would run the cell")
    rc = run_module.main(["--workload", "m7b-docqa32k-closed", "--seed", "1",
                          "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0
    assert out.out == ""
    assert "CUDA" in out.err
