"""``pruned_topk``: fused block-pruned exact cosine top-k.

Replaces the TPU kernel ``src/repro/kernels/cosine_topk.py:pruned_topk``
(body ``_make_kernel``, ``pallas_call`` at line 310).  Per (query tile
``bm``, db tile ``bn``), in ``block_order`` visit order:

  1. the Eq. 13 interval bound, min over pivots (∩ optional ``ub_cap``),
     over each query's pivot-similarity interval (``kernels/ref.py``
     ``query_interval`` and ``box_bound``);
  2. skip the tile unless ``any((ub + margin >= τ) & live)`` for the rows'
     running k-th best τ;
  3. else fp32 ``q @ dbᵀ``, masked by ``row_valid``, merged into a running
     top-k seeded with ``tau_init - 1e-6``.

On CUDA tensors the wrapper launches the hand-written kernel in
``csrc/pruned_topk.cu`` (its header says what bounds it on the H100 and
how the design answers that); on CPU tensors it runs
:func:`pruned_topk_plain`, a tile emulator with the same visit order, skip
predicate and merge (it runs on the card too, where it is the kernel's
yardstick).

The merge keeps the first k of a stable descending sort of
``concat(top, scores)``: an existing slot beats an equal new score, a lower
column beats a higher one.  Slots that stay ``-inf`` carry id ``-1``, the
documented ``(-inf, -1)`` contract (the reference's argmax extraction
repeats lane 0's id there instead; ROADMAP Queue 3).

``splits`` cuts each query tile's visit order into interleaved shares,
one CTA each, with partial top-k lists; :func:`choose_splits` picks it
from the card's SM count and the kernel's occupancy.  The kernel merges
the lists in its epilogue (the last split CTA of each query tile to
finish), as :func:`merge_splits_plain` does, and writes row ``r`` to
output row ``row_out[r]``, so a caller that sorted its queries gets them
back in its own order from the one launch.  :func:`merge_splits` and its
kernel, the unfused route, stay only as the epilogue's yardstick; no
engine path calls them.

``pruned_topk.launches`` and ``merge_splits.launches`` count kernel
launches (never plain calls).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from repro_torch.kernels import ref as kref
from repro_torch.kernels._build import check_operand, library

__all__ = ["pruned_topk", "pruned_topk_plain", "merge_splits",
           "merge_splits_plain", "choose_splits", "default_splits",
           "DEFAULT_BM", "DEFAULT_BN", "MAX_K"]

DEFAULT_BM = 128
DEFAULT_BN = 256
#: the kernel's limits: query rows per CTA and pivots per bound
MAX_BM = 128
MAX_PIVOTS = 64
#: the largest k the kernel's epilogue merges (3k pairs in its copy ring)
MAX_K = 1024
#: rows of a k-major panel the kernel copies and scores at once
_PANEL = 128
_NEG_INF = float("-inf")


def _emulate(qn: Tensor, db: Tensor, qp: Tensor, lo: Tensor, hi: Tensor,
             tau: Tensor, block_order: Tensor, row_valid: Tensor,
             ub_cap: Tensor | None, dp: Tensor | None, *, k: int, bm: int,
             bn: int, m_valid: int, margin: float, prune: bool,
             splits: int = 1, row_out: Tensor | None = None,
             gaps: bool = False):
    """Tile emulator of the kernel: loops over visit steps and handles every
    (query tile, split) pair at once as its own virtual query tile, each
    gathering its own db tile.  Split ``s`` of query tile ``i`` visits
    ``block_order[i, s::splits]`` with its own running top-k; where
    ``nt % splits != 0`` the short splits take "no tile" steps at the end.
    The partial lists then merge as :func:`merge_splits_plain` does, and
    row ``r`` goes to row ``row_out[r]`` of the result.
    ``tau`` [M] holds the already-lowered seeds (``-inf`` = none).

    ``gaps=True`` also returns, per (query tile, db tile), how close each
    decision came to the other side: ``gap`` [Mt, Nt] f32 is the largest
    ``ub + margin - τ`` over live rows at the visit (with pruning on and
    no NaN bound, ``computed`` is ``gap >= 0``), and ``near`` [Mt, Nt] i32
    counts the elements whose ``eub + margin`` lies within ``2·margin`` of
    τ.  A version whose τ differs by fp32 summation order may flip only
    where these are small.
    """
    m, d = qn.shape
    n, p = db.shape[0], qp.shape[1]
    nt = n // bn
    mt = -(-m // bm)
    pad = mt * bm - m
    dev = qn.device
    steps = -(-nt // splits)

    def tiles(x, fill):
        """[M, ...] -> [mt * splits, bm, ...]: one copy per split."""
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
        return x.reshape((mt, bm) + tuple(x.shape[1:])).repeat_interleave(
            splits, 0)

    q_t = tiles(qn.float(), 0.0)                           # [mv, bm, d]
    qp_t = tiles(qp.float(), 1.0)                          # [mv, bm, p]
    a_lo, a_hi = kref.query_interval(qp_t)
    live = tiles(torch.arange(m, device=dev) < m_valid, False)
    top_s = tiles(tau.float(), _NEG_INF)[:, :, None].repeat(1, 1, k)
    mv = top_s.shape[0]
    top_i = torch.full((mv, bm, k), -1, dtype=torch.int32, device=dev)
    cap_t = None if ub_cap is None else tiles(ub_cap.float(), 0.0)
    computed = torch.zeros(mt, nt, dtype=torch.int32, device=dev)
    elem = (None if dp is None
            else torch.zeros(mt, nt, dtype=torch.int32, device=dev))
    gap = torch.zeros(mt, nt, device=dev) if gaps else None
    near = torch.zeros(mt, nt, dtype=torch.int32, device=dev) if gaps else None
    db_t = db.float().reshape(nt, bn, d)
    rv_t = row_valid.reshape(nt, bn).bool()
    dp_t = None if dp is None else dp.float().reshape(nt, bn, p)
    ar = torch.arange(mv, device=dev)
    tile_of = ar // splits                                 # real query tile
    cols = torch.arange(bn, device=dev, dtype=torch.int32)
    # [mv, steps] visit order per virtual tile, -1 for "no tile"
    order = torch.cat([block_order.long(), block_order.new_full(
        (mt, steps * splits - nt), -1).long()], 1)
    order = order.reshape(mt, steps, splits).transpose(1, 2).reshape(mv, steps)

    for j in range(steps):
        active = order[:, j] >= 0                          # [mv]
        jb = order[:, j].clamp(min=0)
        lo_j, hi_j = lo[jb].float()[:, None, :], hi[jb].float()[:, None, :]
        ub = kref.box_bound(a_lo, a_hi, lo_j, hi_j).amin(-1)   # [mv, bm]
        if cap_t is not None:
            ub = torch.minimum(ub, cap_t[ar, :, jb])
        tau_j = top_s[:, :, k - 1]
        vmask = rv_t[jb]                                   # [mv, bn]
        if prune:
            needed = ((ub + margin >= tau_j) & live).any(1)
        else:
            needed = torch.ones(mv, dtype=torch.bool, device=dev)
        needed &= active
        at = (tile_of[active], jb[active])
        computed[at] = needed[active].int()
        if gap is not None:
            gap[at] = torch.where(live, (ub + margin) - tau_j,
                                  _NEG_INF).amax(1)[active]
        if elem is not None:
            dpj = dp_t[jb]                                 # [mv, bn, p]
            eub = None
            for q in range(p):
                b = dpj[:, None, :, q]                     # [mv, 1, bn]
                cand = kref.box_bound(a_lo[:, :, q:q + 1], a_hi[:, :, q:q + 1],
                                      b, b)
                eub = cand if eub is None else torch.minimum(eub, cand)
            counted = vmask[:, None, :] & live[:, :, None]
            pruned = (eub + margin < tau_j[:, :, None]) & counted
            elem[at] = pruned.sum((1, 2)).int()[active]
            if near is not None:
                close = ((eub + margin) - tau_j[:, :, None]).abs() <= 2 * margin
                near[at] = (close & counted).sum((1, 2)).int()[active]
        if not bool(needed.any()):
            continue
        scores = torch.bmm(q_t, db_t[jb].transpose(1, 2))  # [mv, bm, bn]
        # masked rows, and every row of a skipped tile, merge as -inf,
        # which leaves the running top-k unchanged
        keep = vmask[:, None, :] & needed[:, None, None]
        scores = scores.masked_fill(~keep, _NEG_INF)
        col = (jb.int() * bn)[:, None] + cols              # [mv, bn]
        cand_s = torch.cat([top_s, scores], -1)
        cand_i = torch.cat([top_i, col[:, None, :].expand(mv, bm, bn)], -1)
        top_s, sel = torch.sort(cand_s, dim=-1, descending=True, stable=True)
        top_s, sel = top_s[..., :k].contiguous(), sel[..., :k]
        top_i = torch.gather(cand_i, -1, sel)

    def parts(x):
        """[mv, bm, k] -> [splits, M, k]"""
        x = x.reshape(mt, splits, bm, k).transpose(0, 1)
        return x.reshape(splits, mt * bm, k)[:, :m]

    if splits == 1:
        out_s, out_i = parts(top_s)[0], parts(top_i)[0]
    else:
        out_s, out_i = merge_splits_plain(parts(top_s), parts(top_i))
    if row_out is not None:
        out_s, out_i = scatter_rows(out_s, row_out), scatter_rows(out_i, row_out)
    out = (out_s, out_i, computed, elem)
    return out + (gap, near) if gaps else out


def scatter_rows(x: Tensor, row_out: Tensor) -> Tensor:
    """``out[row_out[r]] = x[r]``: rows back to the caller's order."""
    out = torch.empty_like(x)
    out[row_out.long()] = x
    return out


def merge_splits_plain(part_s: Tensor, part_i: Tensor):
    """The plain version of :func:`merge_splits`: a stable descending sort
    of each row's ``splits · k`` entries in (split, slot) order, cut to k.
    Returns ``(sims [M, k], idx [M, k])``."""
    s, m, k = part_s.shape
    cat_s = part_s.transpose(0, 1).reshape(m, s * k)
    cat_i = part_i.transpose(0, 1).reshape(m, s * k)
    top_s, sel = torch.sort(cat_s, dim=-1, descending=True, stable=True)
    return top_s[:, :k].contiguous(), torch.gather(cat_i, 1, sel[:, :k])


def merge_splits(part_s: Tensor, part_i: Tensor):
    """Reduce per-split top-k lists ``[S, M, k]`` to ``[M, k]``: score
    descending, then split, then slot; slots that stay ``-inf`` carry the
    ``-1`` ids they had.  CPU tensors run :func:`merge_splits_plain`;
    CUDA tensors launch ``merge_splits_kernel`` in ``csrc/pruned_topk.cu``
    or raise.  ``merge_splits.launches`` counts kernel launches.

    The unfused route: :func:`pruned_topk` merges in its kernel's epilogue
    and never calls this; ``chip_smoke.py`` times the two against each
    other."""
    if part_s.device.type == "cpu":
        return merge_splits_plain(part_s, part_i)
    if part_s.device.type != "cuda":
        raise ValueError(f"merge_splits runs on cpu or cuda, not {part_s.device}")
    s, m, k = part_s.shape
    dev = part_s.device
    check_operand("part_s", part_s, (s, m, k), torch.float32, dev)
    check_operand("part_i", part_i, (s, m, k), torch.int32, dev)
    top_s = torch.empty(m, k, dtype=torch.float32, device=dev)
    top_i = torch.empty(m, k, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _lib().merge_splits_launch(
            part_s.data_ptr(), part_i.data_ptr(), top_s.data_ptr(),
            top_i.data_ptr(), m, k, s, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"merge_splits kernel launch failed: CUDA error {rc}")
    merge_splits.launches += 1
    return top_s, top_i


merge_splits.launches = 0


def choose_splits(mt: int, nt: int, sm_count: int, ctas_per_sm: int) -> int:
    """Splits of the db axis for ``mt`` query tiles over ``nt`` db tiles on
    a card of ``sm_count`` SMs holding ``ctas_per_sm`` CTAs each.

    With ``slots = sm_count · ctas_per_sm`` resident CTAs, the ``mt · S``
    CTAs run in ``waves(S) = ceil(mt · S / slots)`` waves, each CTA doing
    ``1 / S`` of a query tile's work, so the kernel's time goes as
    ``cost(S) = waves(S) / S``.  Its least value over ``1 <= S <= slots``
    is ``mt / slots`` (whole waves, no tail) once ``nt >= slots``.  More
    splits compute more tiles (each split's τ rises on its share of the
    tiles only) and merge more lists, so this takes the smallest ``S <=
    nt`` whose cost is within 15 % of the least:

        S = min{S : cost(S) <= 1.15 · min_S' cost(S')}

    At 79 query tiles and 264 slots: S = 3, 237 CTAs in one wave (S = 4
    gives 316 CTAs, 1.2 waves, the cost of 2).  One query tile: S = 230.
    """
    if mt < 1 or nt < 1 or sm_count < 1 or ctas_per_sm < 1:
        raise ValueError(f"choose_splits({mt}, {nt}, {sm_count}, {ctas_per_sm})")
    slots = sm_count * ctas_per_sm
    top = min(nt, slots)
    cost = [-(-mt * s // slots) / s for s in range(1, top + 1)]
    best = min(cost)
    return next(s for s, c in enumerate(cost, 1) if c <= 1.15 * best)


def default_splits(m: int, n: int, d: int, p: int, *, bm: int, bn: int,
                   device) -> int:
    """The splits the engine runs at: 1 on the CPU (the plain version's
    single pass), :func:`choose_splits` with the card's SM count and the
    kernel's occupancy at ``(d, p)`` on CUDA."""
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    ctas = _lib().pruned_topk_ctas_per_sm(d, p)
    if ctas < 1:
        raise RuntimeError(f"pruned_topk cannot be resident at d={d}, p={p}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return choose_splits(-(-m // bm), n // bn, sms, ctas)


def _lib():
    lib = library("pruned_topk")
    if not getattr(lib, "_typed", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.pruned_topk_launch.argtypes = (
            [vp] * 17 + [i] * 9 + [ctypes.c_float, i, i, i, vp])
        lib.pruned_topk_launch.restype = i
        lib.merge_splits_launch.argtypes = [vp] * 4 + [i] * 3 + [vp]
        lib.merge_splits_launch.restype = i
        lib.pruned_topk_ctas_per_sm.argtypes = [i, i]
        lib.pruned_topk_ctas_per_sm.restype = i
        lib._typed = True
    return lib


class Launch(NamedTuple):
    """What one launch of the kernel leaves: the result, the partial lists
    it merged (``[splits, M, k]``) and each query tile's merge clock."""
    sims: Tensor | None
    idx: Tensor | None
    computed: Tensor
    elem: Tensor | None
    part_s: Tensor
    part_i: Tensor
    #: [3, M_tiles] i32 from %globaltimer: ns the epilogue's merge took,
    #: then the low 32 bits of the ns clock at the tile's last arrival and
    #: at its merge's end (zeros unfused)
    merge_clock: Tensor


def _launch(qn, db, qp, lo, hi, tau, block_order, row_valid, ub_cap, dp, *,
            k, bm, bn, m_valid, margin, prune, splits, row_out=None,
            fused=True) -> Launch:
    """Validate the operands and launch ``csrc/pruned_topk.cu``'s main
    kernel.  The partial lists stay in ``part_s``/``part_i`` and the
    epilogue merges them into ``sims``/``idx``, row ``r`` at row
    ``row_out[r]``.  ``fused=False`` (the unfused route, for comparison
    only) launches the kernel without its epilogue: ``sims`` and ``idx``
    are None and the partial lists are the result."""
    m, d = qn.shape
    n, p = db.shape[0], qp.shape[1]
    nt, mt = n // bn, -(-m // bm)
    dev = qn.device
    if db.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(
            f"pruned_topk's CUDA kernel takes float32 or bfloat16 db rows, got {db.dtype}")
    if not 1 <= bm <= MAX_BM:
        raise ValueError(f"bm={bm} outside [1, {MAX_BM}] for the CUDA kernel")
    if not 1 <= p <= MAX_PIVOTS:
        raise ValueError(f"{p} pivots outside [1, {MAX_PIVOTS}]")
    if k > MAX_K:
        raise ValueError(f"k={k} past the CUDA kernel's merge limit of {MAX_K}")
    if row_out is not None and not fused:
        raise ValueError("row_out needs the fused kernel")
    f32 = torch.float32
    check_operand("qn", qn, (m, d), f32, dev)
    check_operand("db", db, (n, d), db.dtype, dev)
    check_operand("qp", qp, (m, p), f32, dev)
    check_operand("dp_min", lo, (nt, p), f32, dev)
    check_operand("dp_max", hi, (nt, p), f32, dev)
    check_operand("tau", tau, (m,), f32, dev)
    check_operand("block_order", block_order, (mt, nt), torch.int32, dev)
    check_operand("row_valid", row_valid, (n,), torch.bool, dev)
    if ub_cap is not None:
        check_operand("ub_cap", ub_cap, (m, nt), f32, dev)
    if dp is not None:
        check_operand("dp", dp, (n, p), f32, dev)
    if row_out is not None:
        check_operand("row_out", row_out, (m,), torch.int32, dev)
    # the kernel reads every tile k-major in panels of 128 rows, [panel][D]
    # [128], zero past a tile's rows: each K-step of a panel is one
    # contiguous bulk copy, and each column a thread's float4 fragments.
    # The db panels keep the db's dtype: a bf16 db is read as bf16
    qt = qn.new_zeros(mt, d, _PANEL)
    qt[:, :, :bm] = torch.cat([qn, qn.new_zeros(mt * bm - m, d)]).view(
        mt, bm, d).transpose(1, 2)
    nsub = -(-bn // _PANEL)
    dbt = db.view(nt, bn, d)
    if bn % _PANEL:
        dbt = torch.cat([dbt, dbt.new_zeros(nt, nsub * _PANEL - bn, d)], 1)
    dbt = dbt.reshape(nt * nsub, _PANEL, d).transpose(1, 2).contiguous()
    # each tile's pivot intervals in one row (lo, then hi, each padded to a
    # multiple of 4), copied with the tile's first K-step
    pp = -(-p // 4) * 4
    lh = lo.new_zeros(nt, 2 * pp)
    lh[:, :p], lh[:, pp:pp + p] = lo, hi
    part_s = torch.empty(splits, m, k, dtype=f32, device=dev)
    part_i = torch.empty(splits, m, k, dtype=torch.int32, device=dev)
    # computed, then the epilogue's arrival count per query tile (which it
    # leaves holding the tile's merge clock): one zero-filled allocation, so
    # no state outlives the call
    zeros = torch.zeros(mt * nt + 3 * mt, dtype=torch.int32, device=dev)
    computed, arrive = zeros[:mt * nt].view(mt, nt), zeros[mt * nt:].view(3, mt)
    elem = (None if dp is None
            else torch.zeros(mt, nt, dtype=torch.int32, device=dev))
    sims = idx = None
    if fused:
        sims = torch.empty(m, k, dtype=f32, device=dev)
        idx = torch.empty(m, k, dtype=torch.int32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        rc = _lib().pruned_topk_launch(
            ptr(qt), ptr(dbt), ptr(qp), ptr(lh), ptr(tau),
            ptr(block_order), ptr(row_valid), ptr(ub_cap), ptr(dp),
            ptr(part_s), ptr(part_i), ptr(computed), ptr(elem), ptr(sims),
            ptr(idx), ptr(row_out), ptr(arrive), m, m_valid, n, d, p, k, bm,
            bn, splits, margin, int(prune), int(fused), int(db.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"pruned_topk kernel launch failed: CUDA error {rc}")
    pruned_topk.launches += 1
    return Launch(sims, idx, computed, elem, part_s, part_i, arrive)


def _check_ids(block_order: Tensor, nt: int, row_out: Tensor | None, m: int):
    """Raise unless ``block_order`` holds tile ids in ``[0, nt)`` and
    ``row_out`` rows in ``[0, m)``: the kernel indexes with both unchecked.
    One host sync for both."""
    ends = [*torch.aminmax(block_order)]
    if row_out is not None:
        ends += [*torch.aminmax(row_out)]
    ends = torch.stack(ends).tolist()
    if ends[0] < 0 or ends[1] >= nt:
        raise ValueError(f"block_order holds tile ids outside [0, {nt})")
    if row_out is not None and (ends[2] < 0 or ends[3] >= m):
        raise ValueError(f"row_out holds rows outside [0, {m})")


def _operands(qn, db, qp, dp_min, dp_max, n_valid, m_valid=None,
              tau_init=None, block_order=None, dp=None, ub_cap=None,
              row_valid=None, *, k, bm=DEFAULT_BM, bn=DEFAULT_BN, margin=4e-7,
              prune=True, element_stats=False, splits=1, row_out=None):
    """The reference wrapper's argument handling: defaults, the τ seeds
    lowered by 1e-6 so genuine candidates at τ displace them, checks."""
    m = qn.shape[0]
    n = db.shape[0]
    dev = qn.device
    if n % bn or dp_min.shape[0] != n // bn:
        raise ValueError(f"db rows {n} must be whole tiles of bn={bn} "
                         f"matching dp_min {tuple(dp_min.shape)}")
    if not 1 <= k <= bn:
        raise ValueError(f"k={k} must be in [1, bn={bn}]")
    if element_stats and dp is None:
        raise ValueError("element_stats=True requires dp ([N, P] per-row "
                         "pivot similarities)")
    m_valid = m if m_valid is None else int(m_valid)
    if row_valid is None:
        row_valid = torch.arange(n, device=dev) < int(n_valid)
    if tau_init is None:
        tau = torch.full((m,), _NEG_INF, dtype=torch.float32, device=dev)
    else:
        tau = tau_init.float().reshape(m) - 1e-6
    grid = (-(-m // bm), n // bn)
    if not 1 <= splits <= grid[1]:
        raise ValueError(f"splits={splits} must be in [1, {grid[1]} db tiles]")
    if block_order is None:
        block_order = torch.arange(grid[1], dtype=torch.int32,
                                   device=dev)[None, :].expand(grid)
    if tuple(block_order.shape) != grid:
        raise ValueError(f"block_order shape {tuple(block_order.shape)} != {grid}")
    block_order = block_order.int().contiguous()
    if row_out is not None:
        check_operand("row_out", row_out, (m,), torch.int32, dev)
    _check_ids(block_order, grid[1], row_out, m)
    operands = (qn, db, qp, dp_min, dp_max, tau, block_order,
                row_valid.bool(), ub_cap, dp if element_stats else None)
    return operands, dict(k=k, bm=bm, bn=bn, m_valid=m_valid, margin=margin,
                          prune=prune, splits=splits, row_out=row_out)


def pruned_topk_plain(*args, gaps: bool = False, **kwargs):
    """The plain PyTorch version of :func:`pruned_topk`, same signature and
    outputs, on the operands' device: a tile emulator with the kernel's
    visit order, skip predicate and merge.  ``gaps=True`` appends the
    ``(gap, near)`` margins of its skip and element decisions (see
    :func:`_emulate`), to tell a flip of fp32 noise from a fault."""
    operands, kw = _operands(*args, **kwargs)
    return _emulate(*operands, **kw, gaps=gaps)


def pruned_topk(
    qn: Tensor,
    db: Tensor,
    qp: Tensor,
    dp_min: Tensor,
    dp_max: Tensor,
    n_valid: int,
    m_valid: int | None = None,
    tau_init: Tensor | None = None,
    block_order: Tensor | None = None,
    dp: Tensor | None = None,
    ub_cap: Tensor | None = None,
    row_valid: Tensor | None = None,
    *,
    k: int,
    bm: int = DEFAULT_BM,
    bn: int = DEFAULT_BN,
    margin: float = 4e-7,
    prune: bool = True,
    element_stats: bool = False,
    splits: int = 1,
    row_out: Tensor | None = None,
):
    """Fused exact top-k with block pruning (the reference's signature,
    plus ``splits`` and ``row_out``).

    Args:
      qn: [M, D] L2-normalized queries.  db: [N, D] normalized database,
        float32 or bfloat16.  A bf16 db is scored as the reference scores
        it: the fp32 dot product of the query with the bf16-rounded row,
        the tile skip against the fp32 ``dp_min``/``dp_max`` as given.
        The rounded rows are not unit norm, so the Eq. 13 bound is not
        proven for them: the result is held to the fp32 brute force only
        as the reference holds it, within 2e-2.
      qp: [M, P] query-pivot similarities, each the float64 cosine rounded
        to nearest; the bound runs over their float32 neighbours.
      dp_min/dp_max: [N // bn, P] pivot intervals at kernel tile granularity.
      n_valid: real rows in db (the prefix mask when ``row_valid`` is None).
      m_valid: live query rows (default M); later rows never force a tile.
      tau_init: [M] τ warm-start seeds (true lower bounds on each k-th best).
      block_order: [M_tiles, N_tiles] per-query-tile db tile visit order.
      dp: [N, P] per-row pivot similarities (required by ``element_stats``).
      ub_cap: [M, N_tiles] extra per-(query, tile) upper bounds.
      row_valid: [N] per-row validity (tombstones need not be a prefix).
      k: top-k, ``k <= bn``.
      splits: db-axis splits per query tile (:func:`choose_splits`): split
        ``s`` visits ``block_order[i, s::splits]`` with its own top-k and
        τ, and the partial lists merge (:func:`merge_splits_plain`'s order)
        in the kernel's epilogue.  Exact at any value; ``computed``
        matches the reference's only at 1 and is a superset of it otherwise.
      row_out: [M] i32, a permutation of ``range(M)``: row ``r``'s result
        goes to row ``row_out[r]`` (a caller that sorted its queries by
        ``perm`` passes ``perm`` and gets its own order back).  Ids outside
        ``[0, M)`` raise.  ``computed`` and ``elem`` stay indexed by query
        tile of the rows as given.

    Returns ``(sims [M, k] f32, idx [M, k] i32 db positions, computed
    [M_tiles, N_tiles] i32 by tile id, elem [M_tiles, N_tiles] i32 or
    None)``.  CPU tensors run :func:`pruned_topk_plain`; CUDA tensors
    launch the kernel once, at any ``splits``, or raise.
    """
    operands, kw = _operands(
        qn, db, qp, dp_min, dp_max, n_valid, m_valid, tau_init, block_order,
        dp, ub_cap, row_valid, k=k, bm=bm, bn=bn, margin=margin, prune=prune,
        element_stats=element_stats, splits=splits, row_out=row_out)
    if qn.device.type == "cpu":
        return _emulate(*operands, **kw)
    if qn.device.type != "cuda":
        raise ValueError(f"pruned_topk runs on cpu or cuda, not {qn.device}")
    return _launch(*operands, **kw)[:4]


pruned_topk.launches = 0
