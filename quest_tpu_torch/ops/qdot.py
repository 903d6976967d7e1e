"""Products with weight-only quantized weights on the card (no Pallas
counterpart; the JAX package leaves them to XLA, which fuses the
dequantization of ``quest_tpu/models/quantize.py:qdot`` into the dot's
operand read).

Weights are one layer of a ``models.quantize.QuantizedLinear``: ``q``
int8 [in, out] (int4: [in/2, out], the block-split nibble pack), ``s``
f32 [1, out] and optional ``inv_s`` f32 [in] (the AWQ fold).

- :func:`qgemv`: ``x`` [M <= 16, in] times the weights, for the decode
  rows. On a CUDA tensor it launches ``csrc/qgemv.cu``'s
  ``qgemv_ring_kernel`` (bf16 x: q streamed by TMA through a
  shared-memory ring, the products on the tensor cores, the input-row
  splits merged inside a thread-block cluster) or ``qgemv_kernel`` (f32
  x, and bf16 x whose out is not a multiple of 16, FMA); on a CPU tensor
  it runs :func:`qgemv_plain`, JAX's expression.
- :func:`dequant`: the weights as a bf16 or f32 [in, out] matrix, for the
  prefill rows' ``torch.matmul``. On a CUDA tensor it launches
  ``csrc/qgemv.cu:dequant_kernel``; on a CPU tensor it runs
  :func:`dequant_plain`, bitwise equal to the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.decode_common import sm_count
from quest_tpu_torch.ops.utils import hold, round_up

MAX_ROWS = 16          # rows of x qgemv takes
# f32 x (qgemv_kernel): 256 output columns a CTA, two CTAs an SM, at most
# 64 splits of the input rows, merged by ticket. A CTA's fixed cost (x
# staged, the row lanes reduced, its partial stored) in q rows of 256
# bytes: ~5 us a wave at the 12.7 GB/s a CTA gets of 3.35 TB/s over 264
# CTAs (measured on the card).
TILE_N = 256
CTAS_PER_SM = 2
MAX_SPLITS = 64
SPLIT_COST = 256
# bf16 x (qgemv_ring_kernel, csrc/qgemv.cu): tiles of 64, 128 or 256
# columns; a ring of 16 KB stages (16384 / tile q rows each); at most 8
# splits, one cluster; shared memory of an H100 SM and of one CTA. The
# plan takes rings of 2 or 4 stages: deeper ones measured no faster
# (exp/qgemv_ablation.py --sweep).
RING_TILES = (64, 128, 256)
RING_PLAN_TILES = (64, 128)       # 256 needs 4 boxes a stage: never faster
RING_STAGE_BYTES = 16384
RING_MAX_STAGES = 12
RING_PLAN_STAGES = (2, 4)
RING_MAX_CLUSTER = 8
SM_SHARED_BYTES = 233472          # 228 KB an SM
BLOCK_SHARED_BYTES = 232448       # 227 KB a CTA at most
BLOCK_RESERVED_BYTES = 1024       # the runtime's share of each CTA
RING_STATIC_BYTES = 2048          # the kernel's barriers and scales
# The plan's time model (ns), fitted to the sweep on the card: device-
# memory rate; the latency a ring stage waits; the TMA unit's time a box
# (a fixed cost a copy, whatever its size); the rate a CTA stages x at;
# a wave's fixed cost (launch, barriers, the first stage, the epilogue);
# the cluster merge, and its share a row of x and a CTA of the cluster;
# the unpacking's issue rate (operations an ns an SM;
# 2.5 an int8 weight, 1.5 an int4 weight).
HBM_BYTES_PER_NS = 3000.0
RING_LATENCY_NS = 1500.0
RING_BOX_NS = 150.0
X_BYTES_PER_NS = 60.0
RING_FIXED_NS = 3000.0
RING_MERGE_NS = 1000.0
RING_MERGE_ROW_NS = 100.0
RING_MERGE_K_NS = 300.0
SM_OPS_PER_NS = 200.0
# The ticket-merge ablation build of the ring kernel reads the f32
# kernel's workspace; exp/qgemv_ablation.py sets this for that build.
RING_TICKETS = False


class QgemvPlan(NamedTuple):
    """One launch: q's rows cut into ``ksplit`` splits of ``chunk`` rows
    for each ``tile_n``-column tile; ``stages`` ring stages (0: the f32
    kernel, which has no ring)."""
    chunk: int
    ksplit: int
    tile_n: int
    stages: int


def dequant_plain(q: torch.Tensor, s: torch.Tensor,
                  inv_s: Optional[torch.Tensor], bits: int,
                  dtype: torch.dtype) -> torch.Tensor:
    """``quest_tpu/models/quantize.py:dequantize_weight``: ``(float(q) *
    s [* inv_s[:, None]]).to(dtype)``; an int4 pack is unpacked to its low
    nibbles (input rows [0, in/2)) then its high ones, sign-extended by
    arithmetic shifts as JAX does."""
    if bits == 4:
        q = torch.cat([(q << 4) >> 4, q >> 4], dim=-2)
    w = q.float() * s
    if inv_s is not None:
        w = w * inv_s[..., :, None]
    return w.to(dtype)


def qgemv_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                inv_s: Optional[torch.Tensor], bits: int,
                dtype: torch.dtype) -> torch.Tensor:
    """JAX's ``qdot`` expression (without its scheduling barrier): the
    activation folded by ``inv_s`` in its own dtype; int8 ``x @ (float(q)
    * s).to(dtype)``; int4 ``x[..., :half] @ lo + x[..., half:] @ hi``
    with each nibble half dequantized and rounded to ``dtype`` alone.
    ``dtype`` is x's (the model's products never mix dtypes)."""
    if inv_s is not None:
        x = x * inv_s.to(x.dtype)
    if bits == 4:
        half = q.shape[-2]
        lo = (((q << 4) >> 4).float() * s).to(dtype)
        hi = ((q >> 4).float() * s).to(dtype)
        return x[..., :half] @ lo + x[..., half:] @ hi
    return x @ (q.float() * s).to(dtype)


def ring_smem(bits: int, M: int, chunk: int, ksplit: int, tile_n: int,
              stages: int) -> int:
    """Dynamic shared memory of one ring-kernel CTA (``csrc/qgemv.cu:
    ring_smem``): alignment slack, the ring, x staged in bf16 (rows
    padded by 16) and the cluster's receive slots."""
    xs = (2 if bits == 4 else 1) * M * (chunk + 16) * 2
    recv = ksplit * M * -(-tile_n // ksplit) * 4 if ksplit > 1 else 0
    return 1024 + stages * RING_STAGE_BYTES + round_up(xs, 16) + recv


def gpc_sms(sms: int):
    """SMs of each GPC: the H100 SXM's 132 as 18, 18, 18, 16, 16, 16, 16,
    14 (15 clusters of 8 fit at one CTA an SM, as measured on the card);
    another count as 8 GPCs as even as it divides."""
    if sms == 132:
        return (18, 18, 18, 16, 16, 16, 16, 14)
    return tuple(sms // 8 + (i < sms % 8) for i in range(8))


def cluster_slots(sms: int, ks: int, per_sm: int) -> int:
    """CTAs that run at once in clusters of ``ks`` with ``per_sm`` CTAs an
    SM: a cluster lives in one GPC."""
    return sum(per_sm * g // ks for g in gpc_sms(sms)) * ks


def _ring_plan(q_rows, N, sms, M, bits):
    """The bf16 kernel's plan: of the (tile, splits, stages) whose CTAs
    cover at least 80% of the SMs (all when none does), the one with the
    least modelled time; fewer splits, then wider tiles, on a tie. Two
    CTAs share an SM when their shared memory fits in half of it. The
    model: waves of CTAs (clusters that fit their GPCs at once), each as
    long as its ring (bytes over the ring's depth a stage latency, or its
    TMA boxes, whichever is longer) or the device memory's share of the
    whole weight, or the busiest SM's unpacking; plus, a wave, a fixed
    cost and the staging of x; plus the cluster merge (more a row of x
    and a CTA of the cluster). Never fewer stages than the warps' sums
    need after the loop (2 KB a row of x)."""
    cands = []
    opw = 1.5 * 2 if bits == 4 else 2.5       # operations a q byte
    xbytes = (2 if bits == 4 else 1) * M * 2  # staged x a q row
    half = SM_SHARED_BYTES // 2 - BLOCK_RESERVED_BYTES - RING_STATIC_BYTES
    full = BLOCK_SHARED_BYTES - RING_STATIC_BYTES
    for tile_n in RING_PLAN_TILES:
        rows = RING_STAGE_BYTES // tile_n     # q rows a stage
        tiles = -(-N // tile_n)
        for ks in range(1, RING_MAX_CLUSTER + 1):
            chunk = round_up(-(-q_rows // ks), rows)
            if (ks - 1) * chunk >= q_rows:
                continue
            for want in RING_PLAN_STAGES:
                stages = max(min(want, chunk // rows), -(-M // 8))
                smem = ring_smem(bits, M, chunk, ks, tile_n, stages)
                if smem > full:
                    continue
                per_sm = 2 if smem <= half else 1
                ctas = tiles * ks
                waves = -(-ctas // cluster_slots(sms, ks, per_sm))
                cta_bytes = chunk * tile_n
                ring = max(cta_bytes * RING_LATENCY_NS
                           / (stages * RING_STAGE_BYTES),
                           (chunk // rows) * (tile_n // 64) * RING_BOX_NS)
                t = max(tiles * tile_n * q_rows / HBM_BYTES_PER_NS,
                        waves * ring,
                        -(-ctas // sms) * cta_bytes * opw / SM_OPS_PER_NS)
                t += waves * (RING_FIXED_NS + xbytes * chunk / X_BYTES_PER_NS)
                t += (RING_MERGE_NS + RING_MERGE_ROW_NS * M
                      + RING_MERGE_K_NS * ks) if ks > 1 else 0.0
                cands.append((ctas < 0.8 * sms, t, ks, -tile_n,
                              QgemvPlan(chunk, ks, tile_n, stages)))
    return min(cands)[-1]


@functools.lru_cache(maxsize=512)   # a decode step asks 225 times
def qgemv_plan(q_rows: int, N: int, sms: int, M: int, bits: int,
               bf16: bool) -> QgemvPlan:
    """The launch of one qgemv call, a pure function of shapes and the SM
    count. bf16 x: :func:`_ring_plan`. f32 x (FMA, 256-column tiles, two
    CTAs an SM, x staged in f32 for M rounded up to a power of two within
    48 KB, chunks a multiple of 16): of the splittings that fit, the one
    with the least modelled time, waves of CTAs each as long as its chunk
    plus a fixed cost (staging, reduction, its partial) in q rows; fewer
    splits on a tie."""
    if bf16:
        return _ring_plan(q_rows, N, sms, M, bits)
    tiles = -(-N // TILE_N)
    mt = next(m for m in (1, 2, 4, 8, 16) if m >= M)
    max_chunk = (48 << 10) // (mt * (2 if bits == 4 else 1) * 4)
    best = None
    for want in range(1, min(MAX_SPLITS, max(1, q_rows // 16)) + 1):
        chunk = round_up(-(-q_rows // want), 16)
        if chunk > max_chunk:
            continue
        ks = -(-q_rows // chunk)
        waves = -(-tiles * ks // (CTAS_PER_SM * sms))
        cost = (waves * (chunk + SPLIT_COST + 4 * mt), ks)
        if best is None or cost < best[0]:
            best = (cost, chunk, ks)
    return QgemvPlan(best[1], best[2], TILE_N, 0)


def _check(dtype, device, q, s, inv_s, bits, K, N):
    if bits not in (4, 8):
        raise ValueError(f"bits={bits}; expected 4 or 8")
    if dtype not in (torch.bfloat16, torch.float32):
        raise NotImplementedError(f"the weight kernels take bf16 or f32 "
                                  f"activations and weights, not {dtype}")
    if bits == 4 and K % 2:
        # JAX's quantize_weight packs rows [0, in/2) with rows [in/2, in)
        # and cannot make such a weight either.
        raise NotImplementedError(f"an int4 weight needs an even in: {K}x{N}")
    if q.dtype != torch.int8 or s.dtype != torch.float32 or (
            inv_s is not None and inv_s.dtype != torch.float32):
        raise TypeError("q must be int8, s and inv_s f32")
    for t in (q, s, inv_s):
        if t is not None and t.device != device:
            raise ValueError("all operands must be on one device")
        if t is not None and not t.is_contiguous():
            raise ValueError("the weight kernels take contiguous operands")


_workspaces = {}


def _workspace(device, parts: int, tiles: int):
    """(partials, tickets) views of buffers cached by device, grown
    (tickets zeroed) when too small; the kernel leaves the tickets at
    zero. A graph being captured holds the buffers (``utils.hold``)."""
    part, tick = _workspaces.get(device, (None, None))
    if part is None or part.numel() < parts:
        part = torch.empty(max(parts, 1), dtype=torch.float32, device=device)
    if tick is None or tick.numel() < tiles:
        tick = torch.zeros(tiles, dtype=torch.int32, device=device)
    _workspaces[device] = (part, tick)
    hold(part, tick)
    return part, tick


_tensor_maps = {}


def _tensor_map(lib, q: torch.Tensor, box_rows: int) -> int:
    """The TMA descriptor of one layer of q (``qgemv_tensor_map``: int8
    [rows, out], boxes of ``box_rows`` x 64 with the 64-byte swizzle),
    cached by (pointer, shape, box): a layer's view of a stacked weight is
    encoded once a tile width; the address of its 128 bytes. A failed
    encode raises."""
    key = (q.data_ptr(), tuple(q.shape), box_rows)
    buf = _tensor_maps.get(key)
    if buf is None:
        fn = lib.qgemv_tensor_map
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        buf = ctypes.create_string_buffer(128)
        code = fn(_build.ptr(q), q.shape[-2], q.shape[-1], box_rows,
                  ctypes.addressof(buf))
        if code != 0:
            raise RuntimeError(f"cuTensorMapEncodeTiled failed for the "
                               f"quantized weight (CUresult {code})")
        _tensor_maps[key] = buf
    return ctypes.addressof(buf)


def qgemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
          inv_s: Optional[torch.Tensor], bits: int,
          dtype: Optional[torch.dtype] = None,
          plan: Optional[QgemvPlan] = None) -> torch.Tensor:
    """``x`` [..., in] (at most ``MAX_ROWS`` rows) times one layer's
    quantized weights -> [..., out] in ``dtype`` (default x's; the
    kernel takes only x's own). ``plan`` replaces :func:`qgemv_plan`'s
    (the ablation's sweep)."""
    dtype = dtype or x.dtype
    if not x.is_cuda:
        return qgemv_plain(x, q, s, inv_s, bits, dtype)
    K = x.shape[-1]
    N = q.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    _check(x2.dtype, x.device, q, s, inv_s, bits, K, N)
    if dtype != x.dtype:
        raise NotImplementedError("qgemv writes x's dtype")
    if not 1 <= M <= MAX_ROWS:
        raise ValueError(f"qgemv takes 1..{MAX_ROWS} rows, not {M}")
    if q.shape[-2] != (K // 2 if bits == 4 else K) or s.numel() != N or (
            inv_s is not None and inv_s.numel() != K):
        raise ValueError(f"weights {tuple(q.shape)} / {tuple(s.shape)} do "
                         f"not match x [.., {K}] at {bits} bits")
    bf16 = x2.dtype == torch.bfloat16
    # The ring kernel reads q by TMA, which needs 16-byte rows: bf16 x with
    # another out takes the FMA kernel (in bf16).
    ring = bf16 and N % 16 == 0
    p = plan or qgemv_plan(q.shape[-2], N, sm_count(x.device), M, bits, ring)
    lib = _build.load("qgemv")
    part = tick = tmap = None
    if ring:
        tmap = _tensor_map(lib, q, RING_STAGE_BYTES // p.tile_n)
    if p.ksplit > 1 and (not ring or RING_TICKETS):
        part, tick = _workspace(x.device, p.ksplit * M * N, -(-N // p.tile_n))
    out = torch.empty((M, N), dtype=dtype, device=x.device)
    code = lib.qgemv_launch(
        _build.ptr(x2), _build.ptr(q), _build.ptr(s), _build.ptr(inv_s),
        _build.ptr(out), _build.ptr(part), _build.ptr(tick), M, K, N, bits,
        int(bf16), p.chunk, p.ksplit, p.tile_n, p.stages,
        ctypes.c_void_p(tmap), _build.stream_of(x))
    _build.check(lib, code, "qgemv")
    qgemv.launches += 1
    return out.reshape(*x.shape[:-1], N)


qgemv.launches = 0


def _dequant_entry(lib):
    fn = lib.dequant_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def dequant(q: torch.Tensor, s: torch.Tensor, inv_s: Optional[torch.Tensor],
            bits: int, dtype: torch.dtype,
            out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer's weights as a ``dtype`` [in, out] matrix, bitwise equal
    to :func:`dequant_plain`; on the card written into ``out`` when given
    (a buffer of at least in * out elements of ``dtype``)."""
    if not q.is_cuda:
        return dequant_plain(q, s, inv_s, bits, dtype)
    K = q.shape[-2] * (2 if bits == 4 else 1)
    N = q.shape[-1]
    _check(dtype, q.device, q, s, inv_s, bits, K, N)
    if s.numel() != N or (inv_s is not None and inv_s.numel() != K):
        raise ValueError("s / inv_s do not match q")
    if out is None:
        out = torch.empty((K, N), dtype=dtype, device=q.device)
    elif out.dtype != dtype or out.numel() < K * N or not out.is_contiguous():
        raise ValueError("out must be a contiguous buffer of dtype with "
                         "room for in * out elements")
    w = out.view(-1)[:K * N].view(K, N)
    lib = _build.load("qgemv")
    code = _dequant_entry(lib)(
        _build.ptr(q), _build.ptr(s), _build.ptr(inv_s), _build.ptr(w), K, N,
        bits, int(dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(lib, code, "dequant")
    dequant.launches += 1
    return w


dequant.launches = 0
