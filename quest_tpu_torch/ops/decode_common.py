"""Launch plan and workspace of the sparse and dense decode kernels
(``csrc/decode_common.cuh``).

Over a bf16 pool the kernel reads the pages by TMA through a tensor map
of the layer (:func:`tensor_map`). The plan is a pure function of shapes: the wrappers read no device value
(``seq_lens``, ``num_valid``, the indices) on the host, so a decode step
has no host sync. CTAs past a row's pages or valid slots exit on the
card. The workspace (split partials and the merge tickets) is allocated
once a device and grown when a larger plan needs it; the kernel leaves
every ticket at zero, so one launch after another on a stream (or a
replay of a captured step) finds them zeroed.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from quest_tpu_torch.ops import _build
from quest_tpu_torch.ops.utils import hold, padded_group, sub_groups

HEAD_DIM = 128
# Splits of a (row, head) at most: the last CTA of a (row, head) reads
# every split's partial, so long tables take longer splits instead.
MAX_SPLITS = 512


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    per_split: int        # pages (dense) or selection slots (sparse) a CTA
    nsplit: int           # CTAs a (batch row, selection head, sub-group)
    grid: tuple           # (nsplit, Hsel * sub-groups, B)
    part_o: int           # f32 elements of the partial numerators
    part_ml: int          # f32 elements of the partials' (m, l)
    tickets: int          # int32 merge tickets, one a (row, head, sub-group)


def decode_plan(B: int, Hsel: int, G: int, page: int, items: int,
                min_tokens: int, ctas: int) -> DecodePlan:
    """The launch of one decode call over ``items`` pages a row (dense:
    the block table's capacity) or selection slots (sparse): a CTA takes
    ``padded_group(G)`` heads of a selection head's G (``sub_groups(G)``
    CTA rows a selection head), and each such unit's items are cut into
    about ``ctas / (B * units)`` splits (``ctas``: the CTAs of one wave on
    the card), none shorter than ``min_tokens`` tokens, so that a full
    table fills one wave."""
    items = max(1, items)
    units = Hsel * sub_groups(G)
    per_split = max(1, min_tokens // page,
                    -(-items // max(1, ctas // (B * units))),
                    -(-items // MAX_SPLITS))
    nsplit = -(-items // per_split)
    parts = B * units * nsplit * padded_group(G)
    return DecodePlan(per_split=per_split, nsplit=nsplit,
                      grid=(nsplit, units, B), part_o=parts * HEAD_DIM,
                      part_ml=parts * 2, tickets=B * units)


_sm_counts = {}


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of ``device`` (a device property, read
    once; no tensor value)."""
    n = _sm_counts.get(device)
    if n is None:
        n = _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


_workspaces = {}


def workspace(device: torch.device, plan: DecodePlan):
    """(part_o, part_ml, tickets) for ``plan`` on ``device``: views of
    buffers cached by device, grown (tickets zeroed) when too small. A
    graph being captured holds the buffers it was given (``utils.hold``),
    so growing them later never frees what its replays write."""
    parts, tickets = _workspaces.get(device, (None, None))
    if parts is None or parts.numel() < plan.part_o + plan.part_ml:
        parts = torch.empty(plan.part_o + plan.part_ml, dtype=torch.float32,
                            device=device)
    if tickets is None or tickets.numel() < plan.tickets:
        tickets = torch.zeros(plan.tickets, dtype=torch.int32, device=device)
    _workspaces[device] = (parts, tickets)
    hold(parts, tickets)
    return parts[:plan.part_o], parts[plan.part_o:], tickets


_tensor_maps = {}


def tensor_map(lib, kvl: torch.Tensor) -> int:
    """The TMA descriptor of one layer of a bf16 pool [Hkv, NP, 2, page,
    128] (``decode_tensor_map`` in ``csrc/decode_common.cuh``), cached by
    (pointer, shape, dtype); the address of its 128 bytes. A failed encode
    raises."""
    key = (kvl.data_ptr(), tuple(kvl.shape), kvl.dtype)
    buf = _tensor_maps.get(key)
    if buf is None:
        fn = lib.decode_tensor_map
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        buf = ctypes.create_string_buffer(128)
        code = fn(_build.ptr(kvl), kvl.shape[0] * kvl.shape[1],
                  kvl.shape[-2], ctypes.addressof(buf))
        if code != 0:
            raise RuntimeError(f"cuTensorMapEncodeTiled failed for the "
                               f"decode pool (CUresult {code})")
        _tensor_maps[key] = buf
    return ctypes.addressof(buf)
