"""Sort-based, mode-ordered MoE dispatch.

Seats N flat (token, group) pairs into fixed ``(G, capacity)`` buffers,
preserving arrival order, dropping pairs the routing policy discarded and
counting pairs that overflow their group's capacity:

  * a stable argsort of the composite key ``group*2 + is_major_only``
    (dropped pairs pushed past every group) keeps arrival order within each
    (group, mode) bucket;
  * per-bucket counts come from a histogram and group start offsets from
    one (G,) cumsum;
  * with 2T-Drop the MAJOR-only flag as the middle key puts each group's
    FULL rows first and its MAJOR-only rows second — the row layout the
    fused kernel needs to skip minor-half tiles.

The port always sorts: the JAX package's CPU-only ``prefer_cumsum_dispatch``
heuristic (a speed choice between two bit-identical planners) is not ported,
and ``cumsum_dispatch`` stays as the oracle the tests hold the sort against.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

I32 = torch.int32


class DispatchPlan(NamedTuple):
    """Seating plan for N flat pairs into (G, capacity) buffers. Per-pair
    arrays are in the ORIGINAL flat-pair order; ``perm``/``group_offsets``
    describe the sorted (buffer) order."""
    perm: torch.Tensor           # (N,) flat-pair ids in buffer order
    group_offsets: torch.Tensor  # (G,) start of each group's run in perm
    counts_full: torch.Tensor    # (G,) kept FULL rows per group (unclamped)
    counts_major: torch.Tensor   # (G,) kept MAJOR-only rows per group
    group: torch.Tensor          # (N,) destination group (clipped to [0, G))
    slot: torch.Tensor           # (N,) buffer row; == capacity when dropped
    overflow: torch.Tensor       # ()  kept pairs discarded by overflow

    @property
    def counts(self) -> torch.Tensor:
        return self.counts_full + self.counts_major

    def kernel_counts(self, capacity: int):
        """(counts_full, counts_major) clamped so full+major <= capacity."""
        cf = torch.clamp(self.counts_full, max=capacity)
        total = torch.clamp(self.counts_full + self.counts_major,
                            max=capacity)
        return cf, total - cf


def group_histogram(ids, n_groups: int, *, mask=None, dtype=I32):
    """O(N) histogram of ``ids`` over [0, n_groups). ``mask`` drops pairs
    (their id may then be arbitrary, even negative). A scatter-add of ones:
    ``torch.bincount`` would read its input's maximum back to the host."""
    flat = ids.reshape(-1).long()
    if mask is not None:
        flat = torch.where(mask.reshape(-1), flat,
                           torch.full_like(flat, n_groups))
    hist = torch.zeros(n_groups + 1, dtype=dtype, device=flat.device)
    hist.scatter_add_(0, flat, torch.ones_like(flat, dtype=dtype))
    return hist[:n_groups]


def _flags(group, keep, major_only):
    N = group.shape[0]
    if keep is None:
        keep = torch.ones((N,), dtype=torch.bool, device=group.device)
    else:
        keep = keep.reshape(-1)
    if major_only is None:
        major_only = torch.zeros((N,), dtype=torch.bool, device=group.device)
    else:
        major_only = major_only.reshape(-1) & keep
    return keep, major_only


def sort_dispatch(group, keep=None, *, n_groups: int, capacity: int,
                  major_only=None) -> DispatchPlan:
    """Build a DispatchPlan by stable argsort of ``(group, mode, arrival)``.
    Slots equal those of ``cumsum_dispatch`` bit for bit."""
    group = group.reshape(-1).to(I32)
    N = group.shape[0]
    G = n_groups
    keep, major_only = _flags(group, keep, major_only)
    bucket = torch.where(keep, group * 2 + major_only.to(I32),
                         torch.full_like(group, 2 * G))
    perm = torch.argsort(bucket, stable=True).to(I32)
    counts2 = group_histogram(bucket, 2 * G)                     # (2G,)
    counts_full = counts2[0::2]
    counts_major = counts2[1::2]
    group_counts = counts_full + counts_major
    group_offsets = (torch.cumsum(group_counts, 0) - group_counts).to(I32)
    inv = torch.empty((N,), dtype=I32, device=group.device)
    inv[perm.long()] = torch.arange(N, dtype=I32, device=group.device)
    g_clip = torch.clamp(group, 0, G - 1)
    slot = inv - group_offsets[g_clip.long()]
    overflow = (keep & (slot >= capacity)).sum(dtype=I32)
    slot = torch.where(keep, torch.clamp(slot, max=capacity),
                       torch.full_like(slot, capacity))
    return DispatchPlan(perm=perm, group_offsets=group_offsets,
                        counts_full=counts_full, counts_major=counts_major,
                        group=g_clip, slot=slot, overflow=overflow)


def cumsum_dispatch(group, keep=None, *, n_groups: int, capacity: int,
                    major_only=None) -> DispatchPlan:
    """O(N·G) reference: dense one-hot + cumsum running counts. Mode
    ordering is two-phase (FULL ranks first, MAJOR-only ranks offset by the
    group's FULL count) so slots match ``sort_dispatch`` exactly."""
    group = group.reshape(-1).to(I32)
    N = group.shape[0]
    G = n_groups
    keep, major_only = _flags(group, keep, major_only)
    g_clip = torch.clamp(group, 0, G - 1).long()

    def running(mask):
        onehot = torch.nn.functional.one_hot(g_clip, G).to(I32)
        onehot = onehot * mask[:, None].to(I32)
        pos = torch.cumsum(onehot, 0).to(I32) - onehot          # (N, G)
        return (torch.gather(pos, 1, g_clip[:, None])[:, 0],
                onehot.sum(0, dtype=I32))

    pos_f, counts_full = running(keep & ~major_only)
    pos_m, counts_major = running(major_only)
    true_slot = torch.where(major_only, counts_full[g_clip] + pos_m, pos_f)
    overflow = (keep & (true_slot >= capacity)).sum(dtype=I32)
    slot = torch.where(keep, torch.clamp(true_slot, max=capacity),
                       torch.full_like(true_slot, capacity))
    group_counts = counts_full + counts_major
    group_offsets = (torch.cumsum(group_counts, 0) - group_counts).to(I32)
    drop = (~keep).to(I32)
    rank_drop = torch.cumsum(drop, 0).to(I32) - drop
    sorted_pos = torch.where(keep, group_offsets[g_clip] + true_slot,
                             group_counts.sum(dtype=I32) + rank_drop)
    perm = torch.empty((N,), dtype=I32, device=group.device)
    perm[sorted_pos.long()] = torch.arange(N, dtype=I32, device=group.device)
    return DispatchPlan(perm=perm, group_offsets=group_offsets,
                        counts_full=counts_full, counts_major=counts_major,
                        group=g_clip.to(I32), slot=slot, overflow=overflow)


def gather_rows(values, plan: DispatchPlan, capacity: int, *,
                index_div: int = 1, fill=0):
    """(G, capacity, ...) buffers GATHERED through the plan; flat pair ``i``
    reads row ``i // index_div``. Rows past a group's kept count are
    ``fill``."""
    N = plan.perm.shape[0]
    dev = values.device
    cap_ar = torch.arange(capacity, device=dev)
    pos = plan.group_offsets[:, None].long() + cap_ar[None, :]
    valid = cap_ar[None, :] < torch.clamp(plan.counts, max=capacity)[:, None]
    src = plan.perm[torch.clamp(pos, 0, N - 1)].long()            # (G, C)
    out = values[src // index_div if index_div > 1 else src]
    mask = valid.reshape(valid.shape + (1,) * (out.ndim - 2))
    return torch.where(mask, out, torch.as_tensor(fill, dtype=out.dtype,
                                                  device=dev))


def scatter_rows(values, plan: DispatchPlan, capacity: int, *,
                 index_div: int = 1, fill=0):
    """The buffer oracle of ``gather_rows``: repeat the rows (flat pair
    ``i`` takes row ``i // index_div``) and scatter them into a
    (G, capacity + 1, ...) buffer at (group, slot). Only the discard row
    ``capacity`` (dropped and overflowed pairs) takes duplicate writes, and
    it is sliced off, so the order of those writes does not matter."""
    N = plan.group.shape[0]
    src = torch.arange(N, device=values.device)
    rows = values[src // index_div if index_div > 1 else src]
    G = plan.group_offsets.shape[0]
    buf = torch.full((G, capacity + 1) + tuple(values.shape[1:]), fill,
                     dtype=values.dtype, device=values.device)
    buf.index_put_((plan.group.long(), plan.slot.long()), rows,
                   accumulate=False)
    return buf[:, :capacity]


def unpermute(out_buf, plan: DispatchPlan):
    """Each flat pair's output row from the (G, C, ...) buffer; dropped or
    overflowed pairs (slot == capacity) read a zero pad row."""
    pad = torch.zeros((out_buf.shape[0], 1) + out_buf.shape[2:],
                      dtype=out_buf.dtype, device=out_buf.device)
    padded = torch.cat([out_buf, pad], dim=1)
    return padded[plan.group.long(), plan.slot.long()]


def sorted_pair_arrays(plan: DispatchPlan, weights, *, index_div: int = 1,
                       pad: int = 0):
    """(tok_sorted, weight_sorted) for the fused MoE pipeline: the source
    row (flat pair id // ``index_div``) and combine weight of each SORTED
    pair position, with ``pad`` trailing (row 0, weight 0) entries."""
    perm = plan.perm.long()
    src = perm // index_div if index_div > 1 else perm
    w = weights.reshape(-1)[perm]
    if pad:
        src = torch.nn.functional.pad(src, (0, pad))
        w = torch.nn.functional.pad(w, (0, pad))
    return src.to(I32), w


def prefer_fused_pipeline(n_tokens: int, n_groups: int, *,
                          use_kernel: bool = False,
                          device: Optional[torch.device] = None) -> bool:
    """Should the MoE forward run the fused dispatch->FFN->combine kernel
    instead of the gather->grouped-FFN->unpermute buffer path? On a CUDA
    device always; on the CPU (where the kernel's plain version stands in)
    only with ``use_kernel``. All paths agree to fp tolerance."""
    del n_tokens, n_groups          # the rule is shape-independent today
    if device is not None and torch.device(device).type == "cuda":
        return True
    return use_kernel


# ---------------------------------------------------------------------------
# Mode helpers: original-expert ("fused") grouping for the fused kernel
# ---------------------------------------------------------------------------

def major_only_flags(keep, p: int):
    """Per-sub-pair MAJOR-only flags from an expanded (T, K*P) keep mask: on
    the major sub-pair only, set when the major half is kept and every minor
    half dropped (2T mode 1)."""
    if p <= 1:
        return torch.zeros_like(keep, dtype=torch.bool)
    T, Kp = keep.shape
    k3 = keep.reshape(T, Kp // p, p)
    flag3 = torch.zeros_like(k3)
    flag3[..., 0] = k3[..., 0] & ~k3[..., 1:].any(-1)
    return flag3.reshape(T, Kp)


class FusedGroups(NamedTuple):
    """Original-expert-granularity view of an expanded sub-pair list."""
    group: torch.Tensor       # (T, K) original expert per pair
    keep: torch.Tensor        # (T, K) any half kept
    major_only: torch.Tensor  # (T, K) only the major half kept
    combine: torch.Tensor     # (T, K) combine weight (shared by the halves)


def fuse_sub_pairs(pairs, p: int) -> FusedGroups:
    """Collapse a (T, K*P) sub-expert pair list to (T, K) ORIGINAL-expert
    groups: one dispatched row per original pair, FULL vs MAJOR-only decided
    by which halves the policy kept (exact under Eq. 13)."""
    T, Kp = pairs.idx.shape
    K = Kp // p
    idx3 = pairs.idx.reshape(T, K, p)
    keep3 = pairs.keep.reshape(T, K, p)
    comb3 = pairs.combine.reshape(T, K, p)
    return FusedGroups(
        group=torch.div(idx3[..., 0], p, rounding_mode="floor"),
        keep=keep3.any(-1),
        major_only=keep3[..., 0] & ~keep3[..., 1:].any(-1),
        combine=comb3[..., 0],
    )
