"""Exact top-k candidate selection over the NMS pair lattice: the threshold
compaction CUDA kernel (`csrc/select.cu`), its plain PyTorch version, and
the two engines built on it.

Counterpart of `efficientteacher_tpu/ops/select_pallas.py`. It replaces a
plain `torch.topk` over the flat (anchors * classes) multi-label lattice of
eval NMS (reference utils/general.py:1024,1061: the max_nms=30000 cap):

  - `exact_topk_rows`: compact the live 128-wide rows of the lattice, gather
    them, and run a small top-k; crowded batches fall through to
  - `exact_topk_elems`: count candidates per image, bisect a per-image
    value threshold tau so that count(s >= tau) lies in [k, cap], compact
    the elements s >= tau, and run a small top-k. Where more than cap - k
    scores tie with the k-th, no tau exists: the bisection narrows to that
    score, and the engine compacts the scores above it and its tie class
    apart.

Both hand `threshold_compact_cuda` their compaction. The element engine's
counts (the candidate total and each bisection pass's T <= 8 thresholds)
go through `count_ge_cuda`, one read of the lattice per pass, as XLA fused
the JAX package's (B, N, T) compare into its sum. The row gather and the
small top-k stay plain PyTorch, as they were XLA code outside the Pallas
kernel. `tier_counts` records which tier each call took.

Exactness contract (both engines): the scores are bit-identical to
`torch.topk`'s over the whole lattice, every returned index is a distinct
real candidate with exactly that score, and every tie class strictly
above the k-th score has identical membership. Beyond JAX's contract,
equal scores come lowest flat index first, `jax.lax.top_k`'s order on the
CPU: each engine's compacted buffer holds its survivors in ascending
index order, and its last top-k is `assigners/topk.topk_lower_index_first`
(as are the plain top-k tiers). So the result is one answer, the same on
every route: the index lists of two engines are equal.
`check_exact_topk` tests the contract.

Not ported (TPU workarounds): the two-float index split `_IDX_SPLIT` (int32
holds N) and the 128-lane carry buffer. Without them no survivor below the
cap is lost, so the buffer needs no slab slack: cap = round_up(k + slack).
"""

from __future__ import annotations

import collections

import torch

from ..assigners.topk import topk_lower_index_first
from ._build import check, library

_T_BISECT = 8   # thresholds counted per bisection pass
_P_BISECT = 5   # value-grid passes before bisecting the float bit patterns
_SLACK = 32768  # capacity beyond k: a wide count window => few passes
# the smallest positive float (a subnormal; neither the kernels nor the
# plain versions flush subnormals to zero)
_TINY = float.fromhex("0x1p-149")

# engine:tier -> calls, over the process (reset it to count one run):
#   rows:r1 / rows:r2       row compaction at rows_cap r1 / 4 * r1
#   rows:topk, elems:topk   lattice too small to compact: a plain top-k
#   rows:to_elems           too many live rows: the element engine
#   elems:tau0              all candidates fit the buffer: no bisection
#   elems:bisect            the bisection found tau
#   elems:ties              a tie class straddles [k, cap]: two compactions
tier_counts: collections.Counter = collections.Counter()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def threshold_compact(scores: torch.Tensor, tau_lo: torch.Tensor,
                      tau_hi: torch.Tensor, cap: int):
    """Plain PyTorch compaction. Per image, the survivors
    tau_lo <= s <= tau_hi of scores (B, N) in ascending index order ->
    (scores (B, cap) f32, idx (B, cap) int32); survivors past `cap` drop
    (later indices first); the tail is score -1, index -1."""
    b, _ = scores.shape
    m = (scores >= tau_lo[:, None]) & (scores <= tau_hi[:, None])
    slot = torch.cumsum(m, 1, dtype=torch.int32) - 1
    m &= slot < cap
    bi, ni = m.nonzero(as_tuple=True)
    out_s = scores.new_full((b, cap), -1.0)
    out_i = torch.full((b, cap), -1, dtype=torch.int32, device=scores.device)
    si = slot[bi, ni].long()
    out_s[bi, si] = scores[bi, ni]
    out_i[bi, si] = ni.int()
    return out_s, out_i


def threshold_compact_cuda(scores: torch.Tensor, tau_lo: torch.Tensor,
                           tau_hi: torch.Tensor, cap: int):
    """`threshold_compact` through the CUDA kernel for CUDA tensors (plain
    version for CPU tensors only). Same arguments and result."""
    if all(x.device.type == "cpu" for x in (scores, tau_lo, tau_hi)):
        return threshold_compact(scores, tau_lo, tau_hi, cap)
    b, n = scores.shape
    if scores.device.type != "cuda" or any(
            x.device != scores.device for x in (tau_lo, tau_hi)):
        raise ValueError("scores, tau_lo and tau_hi must be on one CUDA "
                         "device (or all on the CPU)")
    if any(x.dtype != torch.float32 for x in (scores, tau_lo, tau_hi)):
        raise TypeError("scores, tau_lo and tau_hi must be float32")
    if tau_lo.shape != (b,) or tau_hi.shape != (b,):
        raise ValueError(f"tau shapes {tuple(tau_lo.shape)}, "
                         f"{tuple(tau_hi.shape)} for scores {(b, n)}")
    if not all(x.is_contiguous() for x in (scores, tau_lo, tau_hi)):
        raise ValueError("scores, tau_lo and tau_hi must be contiguous")
    lib = library().lib
    nchunks = _cdiv(n, lib.et_compact_chunk()) if n > 0 else 0
    if not 0 < n < 2 ** 31 or not 0 < cap < 2 ** 31 or b >= 65536 \
            or not 0 < b * nchunks < 2 ** 31:
        raise ValueError(f"unsupported sizes B={b}, N={n}, cap={cap}")
    dev = scores.device
    # ticket counter, then one look-back status word per chunk
    scratch = torch.empty(1 + b * nchunks, dtype=torch.int64, device=dev)
    out_s = torch.empty((b, cap), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, cap), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        code = lib.et_threshold_compact(
            scores.data_ptr(), b, n, tau_lo.data_ptr(), tau_hi.data_ptr(),
            scratch.data_ptr(), cap, out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    check(code, "et_threshold_compact")
    threshold_compact_cuda.launches += 1
    return out_s, out_i


threshold_compact_cuda.launches = 0


def _compact(use_kernel: bool):
    return threshold_compact_cuda if use_kernel else threshold_compact


def _count_ge(scores: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch count: counts[b, t] = #{n : scores[b, n] >=
    taus[b, t]} as int32, one threshold at a time (no (B, N, T) tensor)."""
    return torch.stack([(scores >= taus[:, t, None]).sum(1, dtype=torch.int32)
                        for t in range(taus.shape[1])], 1)


def count_ge_cuda(scores: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """`_count_ge` through the CUDA kernel for CUDA tensors (plain version
    for CPU tensors only): scores (B, N) f32, taus (B, T) f32 with
    T <= 8 -> (B, T) int32, in one read of the scores."""
    if scores.device.type == "cpu" and taus.device.type == "cpu":
        return _count_ge(scores, taus)
    b, n = scores.shape
    if scores.device.type != "cuda" or taus.device != scores.device:
        raise ValueError("scores and taus must be on one CUDA device (or "
                         "both on the CPU)")
    if scores.dtype != torch.float32 or taus.dtype != torch.float32:
        raise TypeError("scores and taus must be float32")
    lib = library().lib
    if taus.dim() != 2 or taus.shape[0] != b \
            or not 1 <= taus.shape[1] <= lib.et_count_ge_max_t():
        raise ValueError(f"taus {tuple(taus.shape)} for scores {(b, n)}: "
                         f"need (B, T), 1 <= T <= {lib.et_count_ge_max_t()}")
    if not (scores.is_contiguous() and taus.is_contiguous()):
        raise ValueError("scores and taus must be contiguous")
    if n >= 2 ** 31 or b >= 65536:
        raise ValueError(f"unsupported sizes B={b}, N={n}")
    t = taus.shape[1]
    counts = torch.empty((b, t), dtype=torch.int32, device=scores.device)
    with torch.cuda.device(scores.device):
        code = lib.et_count_ge(scores.data_ptr(), b, n, taus.data_ptr(), t,
                               counts.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    check(code, "et_count_ge")
    count_ge_cuda.launches += 1
    return counts


count_ge_cuda.launches = 0


def _elems_impl(scores: torch.Tensor, k: int, use_kernel: bool = True):
    b, n = scores.shape
    cap = _cdiv(k + _SLACK, 128) * 128
    if n <= cap + 4096:  # compaction can't beat sorting the lattice
        tier_counts["elems:topk"] += 1
        return topk_lower_index_first(scores, k)
    compact = _compact(use_kernel)
    count = count_ge_cuda if use_kernel else _count_ge
    inf = torch.full((b,), float("inf"), device=scores.device)

    def compact_tier(tau):
        buf_s, buf_i = compact(scores, tau.contiguous(), inf, cap)
        ts, pos = topk_lower_index_first(buf_s, k)
        idx = buf_i.gather(1, pos).long()
        return ts, torch.where(ts > 0.0, idx, 0)

    # candidates: s > 0 <=> s >= the smallest positive float
    tiny = torch.full((b, 1), _TINY, device=scores.device)
    total = count(scores, tiny)[:, 0]
    if int(total.max()) <= cap:
        tier_counts["elems:tau0"] += 1
        return compact_tier(torch.zeros(b, device=scores.device))

    # per-image value bisection for tau with count(s >= tau) in [kmin, cap];
    # counts fall as tau rises, so (count > cap) is a prefix of each pass's
    # tau grid and (count < kmin) a suffix: the bracket narrows ~(T+1)x
    kmin = torch.clamp(total, max=k)
    found = total <= cap                     # these images take tau = 0
    tau = torch.zeros(b, device=scores.device)
    lo = torch.zeros(b, device=scores.device)
    hi = scores.max(1).values
    fr = torch.arange(1, _T_BISECT + 1, dtype=torch.float32,
                      device=scores.device) / (_T_BISECT + 1)
    for _ in range(_P_BISECT):
        if bool(found.all()):
            break
        taus = lo[:, None] + fr[None, :] * (hi - lo)[:, None]
        counts = count(scores, taus)                            # (B, T)
        ok = (counts >= kmin[:, None]) & (counts <= cap)
        any_ok = ok.any(1)
        first = ok.int().argmax(1)           # first True (first max index)
        tau = torch.where(~found & any_ok,
                          taus.gather(1, first[:, None])[:, 0], tau)
        n_gt = (counts > cap).sum(1)
        new_lo = torch.where(
            n_gt > 0, taus.gather(1, (n_gt - 1).clamp(min=0)[:, None])[:, 0],
            lo)
        n_lt = (counts < kmin[:, None]).sum(1)
        new_hi = torch.where(
            n_lt > 0,
            taus.gather(1, (_T_BISECT - n_lt).clamp(max=_T_BISECT - 1)[:, None]
                        )[:, 0],
            hi)
        upd = ~(found | any_ok)
        lo = torch.where(upd, new_lo, lo)
        hi = torch.where(upd, new_hi, hi)
        found |= any_ok
    if bool(found.all()):
        tier_counts["elems:bisect"] += 1
        return compact_tier(tau)

    # the grid missed the window, or a tie class straddles [kmin, cap]:
    # bisect the bit patterns of the positive floats (monotone in value)
    # until a count lands in the window or lo, hi are adjacent floats.
    # count(s >= lo) > cap and count(s >= hi) < kmin hold throughout.
    lo_b = lo.view(torch.int32).long()
    hi_b = hi.view(torch.int32).long() + 1   # above a max that ties > cap
    fi = torch.arange(1, _T_BISECT + 1, device=scores.device)
    while True:
        open_ = ~found & (hi_b - lo_b > 1)
        if not bool(open_.any()):
            break
        pts = lo_b[:, None] + (hi_b - lo_b)[:, None] * fi // (_T_BISECT + 1)
        taus = pts.int().view(torch.float32)
        counts = count(scores, taus)
        ok = (counts >= kmin[:, None]) & (counts <= cap) & open_[:, None]
        any_ok = ok.any(1)
        tau = torch.where(any_ok, taus.gather(
            1, ok.int().argmax(1)[:, None])[:, 0], tau)
        n_ge = (counts >= kmin[:, None]).sum(1)     # a prefix of the grid
        upd = open_ & ~any_ok
        lo_b = torch.where(upd & (n_ge > 0), pts.gather(
            1, (n_ge - 1).clamp(min=0)[:, None])[:, 0], lo_b)
        hi_b = torch.where(upd & (n_ge < _T_BISECT), pts.gather(
            1, n_ge.clamp(max=_T_BISECT - 1)[:, None])[:, 0], hi_b)
        found |= any_ok
    if bool(found.all()):
        tier_counts["elems:bisect"] += 1
        return compact_tier(tau)

    # ties: lo is the kmin-th largest score and more than cap - kmin others
    # equal it. Compact the fewer than kmin scores above it, then the tie
    # class alone (lowest indices first); the top-k of the two buffers side
    # by side takes every score above lo, then the lowest-indexed ties.
    tier_counts["elems:ties"] += 1
    tie = ~found
    above = torch.where(tie, hi_b.int().view(torch.float32), tau)
    buf_s, buf_i = compact(scores, above.contiguous(), inf, cap)
    v = lo_b.int().view(torch.float32)
    tie_s, tie_i = compact(scores, torch.where(tie, v, inf).contiguous(),
                           torch.where(tie, v, -inf).contiguous(), cap)
    ts, pos = topk_lower_index_first(torch.cat([buf_s, tie_s], 1), k)
    idx = torch.cat([buf_i, tie_i], 1).gather(1, pos).long()
    return ts, torch.where(ts > 0.0, idx, 0)


def exact_topk_elems(scores: torch.Tensor, k: int, use_kernel: bool = True):
    """Exact top-k of (B, N) masked score rows (non-candidates -1,
    candidates > 0) by element compaction with a value bisection; its cost
    follows the candidate count, not their spread over rows. Returns
    (scores (B, k), idx (B, k) int64); idx is 0 where the score is <= 0.
    `use_kernel=False` runs the plain compaction on any device (the
    reference path for comparisons)."""
    return _elems_impl(scores, k, use_kernel)


def exact_topk_rows(scores: torch.Tensor, k: int, use_kernel: bool = True):
    """Exact top-k of (B, N) masked score rows by 128-wide row compaction:
    one pass marks live rows, the kernel packs the live row indices in
    ascending order, a row gather builds a (rows_cap * 128) buffer in
    ascending flat-index order, and a small top-k orders it. Tiered:
    rows_cap r1 when the densest image fits, 4 * r1 when crowded, else
    `exact_topk_elems`. Same result contract as `exact_topk_elems`."""
    b, n = scores.shape
    r = _cdiv(n, 128)
    rpad = _cdiv(r, 128) * 128
    r1 = min(_cdiv(max(_cdiv(k, 128) + 8, 256), 128) * 128, rpad)
    r2 = min(4 * r1, rpad)
    if r1 * 128 >= n:
        tier_counts["rows:topk"] += 1
        return topk_lower_index_first(scores, k)
    s3 = torch.nn.functional.pad(scores, (0, r * 128 - n),
                                 value=-1.0).view(b, r, 128)
    rowlive = (s3 > 0.0).any(-1)                                 # (B, r)
    nmax = int(rowlive.sum(-1).max())
    if nmax > r2 or (nmax > r1 and r2 == r1):
        tier_counts["rows:to_elems"] += 1
        return _elems_impl(scores, k, use_kernel)
    rows_cap = r1 if nmax <= r1 else r2
    tier_counts["rows:r1" if rows_cap == r1 else "rows:r2"] += 1
    rowscore = rowlive.float()
    half = torch.full((b,), 0.5, device=scores.device)
    inf = torch.full((b,), float("inf"), device=scores.device)
    buf_s, buf_i = _compact(use_kernel)(rowscore, half, inf, rows_cap)
    live = buf_s > 0.0                                        # (B, rows_cap)
    rsel = buf_i.clamp(min=0).long()
    rows = s3.gather(1, rsel[:, :, None].expand(-1, -1, 128))
    rows = torch.where(live[:, :, None], rows, -1.0)
    ts, pos = topk_lower_index_first(rows.view(b, rows_cap * 128), k)
    idx = rsel.gather(1, pos // 128) * 128 + pos % 128
    return ts, torch.where(ts > 0.0, idx, 0)


def check_exact_topk(scores: torch.Tensor, k: int, ts: torch.Tensor,
                     ti: torch.Tensor) -> None:
    """Raise AssertionError unless (ts, ti) meet the exactness contract
    against `torch.topk(scores, k)`: bit-identical scores; every index with
    a score > 0 distinct and holding that score; the same membership of
    every tie class strictly above the k-th score."""
    ref = torch.topk(scores, k, 1).values
    if not torch.equal(ts, ref):
        raise AssertionError("top-k score multisets differ")
    for i in range(scores.shape[0]):
        real = ts[i] > 0
        idx = ti[i][real].long()
        if idx.unique().numel() != idx.numel():
            raise AssertionError(f"image {i}: repeated indices")
        if not torch.equal(scores[i, idx], ts[i][real]):
            raise AssertionError(f"image {i}: index does not hold its score")
        kth = ref[i, -1]
        above = scores[i] > torch.clamp(kth, min=0.0)
        if int((ts[i] > torch.clamp(kth, min=0.0)).sum()) != int(above.sum()):
            raise AssertionError(f"image {i}: tie class membership differs")
