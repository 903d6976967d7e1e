"""The experts' kernels of a decode step (``csrc/moe.cu``: the router,
and the gate/up and down products over the experts that some active row
picked). A prefill chunk's router runs as ``moe_route_chunk_kernel``,
which none of the names below matches, and its experts as grouped
products, so the time is the decode steps' alone, as the work is. Work of
a profiled decode tick: the experts it read, times one
expert's weights (``3 hid I`` parameters), and for every (row, slot)
pair of its steps the products' FLOPs and the rows, SiLU products and
outputs moved; plus each step's router (its weights, the rows' logits).
The experts read are the program's own count, the tick span's
``experts_read`` (``quest_tpu_torch/engine/scheduler.py``) of the
recorder tick that ran inside the harness's tick; where the program has
no such count, the family's expectation for the tick's rows
(``families/mellum.py:expected_experts``)."""

from bench import manifest, program_trace
from bench.work import BYTES

KERNELS = ("moe_route_kernel", "moe_gate_up_kernel", "moe_down_kernel")


def _experts_read(tick):
    """The program's ``experts_read`` of the recorder tick inside the
    harness's ``tick``, or None."""
    rcd = program_trace.recorder()
    if rcd is None:
        return None
    t0, t1 = tick.t0 * program_trace.NS, tick.t1 * program_trace.NS
    for s in rcd.spans("tick"):
        if t0 <= s.t0 and s.t1 <= t1 and "experts_read" in s.attrs:
            return s.attrs["experts_read"]
    return None


def work(rec, tick):
    if tick.kind != "decode" or not tick.steps:
        return 0.0, 0.0
    d = rec.dims
    fam = manifest.family(d["model_type"], rec.here or manifest.HERE)
    L, k = d["num_hidden_layers"], d["num_experts_per_tok"]
    hid, I, E = d["hidden_size"], d["moe_intermediate_size"], d["num_experts"]
    wb = BYTES[d["torch_dtype"]]
    rows = len(tick.decode_rows)          # the burst's active rows
    read = _experts_read(tick)
    if read is None:
        read = tick.steps * L * fam.expected_experts(d, rows)
    pairs = tick.steps * L * rows * k
    flops = 2.0 * 3 * hid * I * pairs + 2.0 * tick.steps * L * rows * hid * E
    byt = (read * 3 * hid * I * wb
           + pairs * (hid + 2 * I + hid) * wb
           + tick.steps * L * (hid * E * wb + rows * hid * wb))
    return flops, byt
