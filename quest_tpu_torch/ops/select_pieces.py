"""The select pieces probe: seven pieces of the fused kernel's top-K
stage over ``[SG, 16, 128]`` f32 (counterpart of the Pallas kernel of
``exp/select_compile2.py``, which only compiled them for the TPU).

On a CUDA tensor :func:`select_pieces` launches
``csrc/select_pieces.cu`` (one CTA a group); on a CPU tensor it runs
:func:`select_pieces_plain`. ``python -m quest_tpu_torch.exp.select_compile2``
launches and checks a stage.
"""

from __future__ import annotations

import torch

from quest_tpu_torch.ops import _build

STAGES = ("reduce3", "cumsum", "full", "radix", "thr", "slice2d", "dot2d")
R, L = 16, 128
INT32_MIN = -2 ** 31


def _sum_groups(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(1, 2), keepdim=True)


def select_pieces_plain(s: torch.Tensor, stage: str) -> torch.Tensor:
    """Eager version of one stage; s [SG, 16, 128] f32 -> f32 of that
    shape. Integers are int32 and ``int(x)`` truncates toward zero."""
    SG = s.shape[0]
    if stage == "reduce3":
        return s + _sum_groups(s)
    if stage == "cumsum":              # _band_cumsum, one band a group
        c = torch.cumsum(s.to(torch.int32).reshape(SG, R * L), dim=1)
        return c.to(torch.float32).reshape(SG, R, L)
    if stage == "full":
        return s + 5.0
    if stage == "radix":
        b = s.contiguous().view(torch.int32)
        key = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
        active = torch.ones_like(key)
        k_rem = torch.full((SG, 1, 1), 128, dtype=torch.int32, device=s.device)
        for sh in (31, 30):
            bit = (key >> sh) & 1       # bit sh, whatever the shift fills
            bit_hi = 1 - bit if sh == 31 else bit
            hi = active * bit_hi
            c = _sum_groups(hi).to(torch.int32)
            go_hi = c >= k_rem
            active = torch.where(go_hi, hi, active * (1 - bit_hi))
            k_rem = torch.where(go_hi, k_rem, k_rem - c)
        return active.to(torch.float32)
    if stage == "thr":
        key = s.to(torch.int32)
        thr = torch.where(key > 3, key, INT32_MIN).amax(dim=(1, 2),
                                                         keepdim=True)
        return (key > thr).to(torch.float32)
    if stage == "slice2d":
        return s + s[:, :, L - 1:]
    if stage == "dot2d":
        tri = torch.triu(torch.ones((R, R), device=s.device), diagonal=1)
        return s + (s[:, :, L - 1] @ tri)[:, :, None]
    raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")


def select_pieces(s: torch.Tensor, stage: str) -> torch.Tensor:
    """One select piece over s [SG, 16, 128] f32 (see
    ``csrc/select_pieces.cu`` for what each stage computes)."""
    if stage not in STAGES:
        raise ValueError(f"unknown stage {stage!r}; one of {STAGES}")
    if s.dim() != 3 or tuple(s.shape[1:]) != (R, L) or s.dtype != torch.float32:
        raise ValueError(f"s must be [SG, {R}, {L}] f32, got "
                         f"{tuple(s.shape)} {s.dtype}")
    if not s.is_cuda:
        return select_pieces_plain(s, stage)
    s = s.contiguous()
    out = torch.empty_like(s)
    lib = _build.load("select_pieces")
    code = lib.select_pieces_launch(_build.ptr(s), _build.ptr(out), s.shape[0],
                                    STAGES.index(stage), _build.stream_of(s))
    _build.check(lib, code, "select_pieces")
    select_pieces.launches += 1
    return out


select_pieces.launches = 0
