"""The page-copy bandwidth probe (counterpart of the Pallas kernels of
``exp/gather_ab.py`` and ``exp/dma_probe.py``, which compute the same
function).

Given a page order ``idx`` (a random permutation to gather, the
identity for a contiguous stream), ``q`` [8, 128] f32 and a bf16 pool
``x`` [npages, PAGE / 128, 128], the probe copies every page and returns

    out = q + 1e-6 * sum_c x[idx[c * ppc], :8, :]      (f32 sums)

over the chunks c of ``ppc`` pages. On a CUDA tensor :func:`copy_probe`
launches ``csrc/copy_probe.cu`` (bulk async copies into a shared-memory
ring on many CTAs, see there); on a CPU tensor it runs
:func:`copy_probe_plain`, which computes ``out`` without the copies. The
probe entry points are ``quest_tpu_torch.exp.dma_probe`` and
``quest_tpu_torch.exp.gather_ab``.
"""

from __future__ import annotations

import dataclasses

import torch

from quest_tpu_torch.ops import _build

STAGE_BYTES = 64 << 10        # the largest stage of the shared-memory ring
SMEM_BYTES = 227 << 10        # shared memory a CTA may use on the H100


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """How the chunks map onto the card: stages of ``pps`` pages, dealt
    out ``per_cta`` consecutive stages to each of ``nctas`` CTAs, each
    with an ``nslot``-stage ring of ``smem`` bytes."""

    pps: int
    nstage: int
    per_cta: int
    nctas: int
    nslot: int
    smem: int

    def describe(self, page_bytes: int, ppc: int) -> str:
        return (f"chunk {ppc * page_bytes >> 10} KB -> {ppc // self.pps} "
                f"stages of {self.pps} pages ({self.pps * page_bytes >> 10} "
                f"KB); {self.nctas} CTAs x {self.per_cta} stages, a ring of "
                f"{self.nslot} stages = {self.smem >> 10} KB a CTA")


def stage_plan(npages: int, page_bytes: int, ppc: int, nslot: int, nsem: int,
               ctas: int) -> StagePlan:
    """The mapping of a probe of ``npages`` pages, chunks of ``ppc``
    pages, onto ``ctas`` CTAs (at most): a stage holds the largest
    divisor of ``ppc`` pages that fits ``STAGE_BYTES`` and that ``nsem``
    divides."""
    if npages % ppc:
        raise ValueError(f"{npages} pages are not whole chunks of {ppc}")
    fits = [d for d in range(1, ppc + 1)
            if ppc % d == 0 and d % nsem == 0 and d * page_bytes <= STAGE_BYTES]
    if not fits:
        raise ValueError(f"no stage of <= {STAGE_BYTES} bytes holds a multiple "
                         f"of nsem={nsem} pages of {page_bytes} bytes")
    pps = max(fits)
    smem = nslot * pps * page_bytes
    if smem > SMEM_BYTES:
        raise ValueError(f"a ring of {nslot} x {pps * page_bytes} bytes "
                         f"exceeds {SMEM_BYTES} bytes of shared memory")
    nstage = npages // pps
    per_cta = -(-nstage // ctas)
    return StagePlan(pps, nstage, per_cta, -(-nstage // per_cta), nslot, smem)


def copy_probe_plain(idx: torch.Tensor, q: torch.Tensor, x: torch.Tensor,
                     ppc: int) -> torch.Tensor:
    """Eager version: the function only (the chunks' first pages)."""
    first = x[idx[::ppc].long(), :8, :].float()
    return q + first.sum(dim=0) * 1e-6


def copy_probe(idx: torch.Tensor, q: torch.Tensor, x: torch.Tensor, *,
               ppc: int, nslot: int = 3, nsem: int = 1, contig: bool = False,
               ctas: int | None = None) -> torch.Tensor:
    """Copy every page of ``x`` in the order ``idx`` and return ``out``
    (module docstring). idx [npages] int32; q [8, 128] f32; x [npages,
    PAGE / 128, 128] bf16, PAGE a multiple of 1024; ``contig`` copies a
    semaphore's share of consecutive pages at once (``idx`` must then be
    the identity). ``ctas`` defaults to the card's SM count."""
    npages = x.shape[0]
    if (x.dim() != 3 or x.shape[2] != 128 or x.shape[1] < 8
            or x.dtype != torch.bfloat16 or idx.shape != (npages,)
            or q.shape != (8, 128)):
        raise ValueError("x must be [npages, PAGE/128 >= 8, 128] bf16, idx "
                         "[npages], q [8, 128]")
    if not x.is_cuda:
        return copy_probe_plain(idx, q, x, ppc)
    if ctas is None:
        ctas = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = stage_plan(npages, x[0].numel() * 2, ppc, nslot, nsem, ctas)
    for t in (idx, q):
        if t.device != x.device:
            raise ValueError("all operands must be on x's device")
    x, q = x.contiguous(), q.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    part = torch.empty((plan.nctas, 8 * 128), dtype=torch.float32,
                       device=x.device)
    out = torch.empty((8, 128), dtype=torch.float32, device=x.device)
    lib = _build.load("copy_probe")
    code = lib.copy_probe_launch(
        _build.ptr(idx), _build.ptr(q), _build.ptr(x), _build.ptr(part),
        _build.ptr(out), x[0].numel(), ppc, plan.pps, nsem, nslot,
        plan.nstage, plan.per_cta, plan.nctas, int(contig),
        _build.stream_of(x))
    _build.check(lib, code, "copy_probe")
    copy_probe.launches += 1
    return out


copy_probe.launches = 0
