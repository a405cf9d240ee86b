"""Fixed-capacity landmark table: the map data model.

Replaces the reference's heap-allocated ``CLandmark`` objects
(CLandmark.h:46-55) and the WINDOW/GRAPH landmark vectors of
``CFundamentalMatcher`` with one struct-of-arrays table of static shape
``[L, ...]`` plus validity masks: landmark birth/death is a masked write
into free slots, and every per-landmark loop of the reference is a batched
op over the whole table.

Measurements (ref ``CMeasurementLandmark``, Types.h:12-54: stereo UVs plus
the world-to-camera transform at observation time) live in a per-landmark
ring buffer ``[L, M, ...]``.

The table is a plain dataclass of tensors on one device; updates return a
new table (``dataclasses.replace``) and never write into the old one's
tensors, so a caller may keep the previous state.
"""

from __future__ import annotations

import dataclasses

import torch

from svi_mapper_tpu_torch.ops.descriptors import (
    DESCRIPTOR_BITS,
    DESCRIPTOR_WORDS,
    hamming_words,
    unpack_bits,
)
from svi_mapper_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class LandmarkTable:
    """Struct-of-arrays map over ``L`` landmark slots, ``M`` measurements each."""

    # --- identity / lifecycle (ref CLandmark.h:46-55) ---
    active: torch.Tensor          # [L] bool — slot in use
    uid: torch.Tensor             # [L] int32 — global landmark id
    age: torch.Tensor             # [L] int32 — frames since creation
    failed: torch.Tensor          # [L] int32 — consecutive failed trackings
    keyframe_presences: torch.Tensor  # [L] int32 (promote to GRAPH at 2)
    opt_success: torch.Tensor     # [L] int32
    opt_failed: torch.Tensor      # [L] int32
    is_optimal: torch.Tensor      # [L] bool

    # --- geometry ---
    pos_w: torch.Tensor           # [L, 3] world position estimate
    uv_left_last: torch.Tensor    # [L, 2] last tracked left pixel
    disparity_last: torch.Tensor  # [L] last disparity (bounds stereo search)

    # --- descriptors, int32 bit patterns (dual-cutoff matching, ref
    #     _getMatch CFundamentalMatcher.cpp:2336) ---
    desc_left_ref: torch.Tensor   # [L, 8] descriptor at creation
    desc_right_ref: torch.Tensor  # [L, 8]
    desc_left_last: torch.Tensor  # [L, 8] most recent left descriptor

    # --- descriptor history ring: periodic snapshots, slots start as copies
    #     of the creation descriptor (gating on it is opt-in, see
    #     config.use_desc_history) ---
    desc_hist: torch.Tensor       # [L, R, 8]
    hist_next: torch.Tensor       # [L] int32 — next ring slot

    # --- per-bit descriptor statistics (ref CBitStatistics Types.h:83) ---
    bit_sum: torch.Tensor         # [L, 256] f32 — sum of observed left bits
    bit_stable: torch.Tensor      # [L, 256] f32 — count of bit == previous bit

    # --- measurement ring buffer ---
    meas_uv: torch.Tensor         # [L, M, 4] (uL, vL, uR, vR)
    meas_T_wc: torch.Tensor       # [L, M, 4, 4] world->LEFT-camera at observation
    meas_count: torch.Tensor      # [L] int32 — total measurements ever
    meas_next: torch.Tensor       # [L] int32 — next ring slot

    @property
    def device(self) -> torch.device:
        return self.active.device

    @property
    def capacity(self) -> int:
        return self.active.shape[0]

    @property
    def max_measurements(self) -> int:
        return self.meas_uv.shape[1]

    @property
    def num_active(self) -> torch.Tensor:
        return torch.sum(self.active)

    def replace(self, **changes) -> "LandmarkTable":
        return dataclasses.replace(self, **changes)


def make_table(capacity: int, max_measurements: int, dtype=torch.float32,
               history_slots: int = 4,
               device: torch.device | str | None = None) -> LandmarkTable:
    """Allocate an empty landmark table (``device=None`` means CUDA)."""
    dev = resolve_device(device)
    L, M, R = capacity, max_measurements, history_slots

    def z(shape, dt):
        return torch.zeros(shape, dtype=dt, device=dev)

    i32 = torch.int32
    return LandmarkTable(
        active=z((L,), torch.bool),
        uid=torch.full((L,), -1, dtype=i32, device=dev),
        age=z((L,), i32),
        failed=z((L,), i32),
        keyframe_presences=z((L,), i32),
        opt_success=z((L,), i32),
        opt_failed=z((L,), i32),
        is_optimal=z((L,), torch.bool),
        pos_w=z((L, 3), dtype),
        uv_left_last=z((L, 2), dtype),
        disparity_last=z((L,), dtype),
        desc_left_ref=z((L, DESCRIPTOR_WORDS), i32),
        desc_right_ref=z((L, DESCRIPTOR_WORDS), i32),
        desc_left_last=z((L, DESCRIPTOR_WORDS), i32),
        desc_hist=z((L, R, DESCRIPTOR_WORDS), i32),
        hist_next=z((L,), i32),
        bit_sum=z((L, DESCRIPTOR_BITS), dtype),
        bit_stable=z((L, DESCRIPTOR_BITS), dtype),
        meas_uv=z((L, M, 4), dtype),
        meas_T_wc=z((L, M, 4, 4), dtype),
        meas_count=z((L,), i32),
        meas_next=z((L,), i32),
    )


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def insert_landmarks(
    table: LandmarkTable,
    new_valid: torch.Tensor,      # [N] bool — which candidates to insert
    pos_w: torch.Tensor,          # [N, 3]
    uv_left: torch.Tensor,        # [N, 2]
    disparity: torch.Tensor,      # [N]
    desc_left: torch.Tensor,      # [N, 8] int32
    desc_right: torch.Tensor,     # [N, 8] int32
    uv4: torch.Tensor,            # [N, 4] first stereo measurement
    T_wc: torch.Tensor,           # [4, 4] current world->camera
    next_uid: torch.Tensor,       # scalar int32
    shards=None,
) -> tuple[LandmarkTable, torch.Tensor]:
    """Write new landmarks into free slots (the batched ``new CLandmark``,
    ref CFundamentalMatcher::addNewLandmarks CFundamentalMatcher.cpp:83-193).

    The k-th valid candidate goes to the k-th free slot; candidates beyond
    the free capacity are dropped (detections arrive score-sorted). The JAX
    package scatters candidates into slots; here every slot GATHERS its
    candidate instead (one small scatter builds the rank -> candidate map,
    whose unused writes collide harmlessly on a spare last entry), which
    gives the same table without data-dependent shapes or host reads.
    Returns the updated table and the new ``next_uid``.

    On a landmark-sharded table (``shards``) every rank passes the same
    candidates and its own rows; a slot's free rank counts the free slots
    of the lower ranks first, so the k-th candidate lands in the same
    global slot as on one device.
    """
    L = table.capacity
    N = new_valid.shape[0]
    dev = table.device
    free = ~table.active                                         # [L]
    free_rank = torch.cumsum(free.to(torch.int32), 0) - 1        # [L]
    cand_rank = torch.cumsum(new_valid.to(torch.int32), 0) - 1   # [N]
    n_free = torch.sum(free.to(torch.int32))
    if shards is not None:
        below, n_free = shards.exclusive_prefix(n_free)
        free_rank = free_rank + below
    n_insert = torch.minimum(torch.sum(new_valid.to(torch.int32)), n_free)

    # rank -> candidate index; invalid candidates write the spare entry N
    cand_of_rank = torch.zeros((N + 1,), dtype=torch.int64, device=dev)
    cand_of_rank[torch.where(new_valid, cand_rank, N).to(torch.int64)] = \
        torch.arange(N, dtype=torch.int64, device=dev)
    fill = free & (free_rank < n_insert)                         # [L]
    src = cand_of_rank[torch.clamp(free_rank, 0, N - 1).to(torch.int64)]

    def put(arr, val):
        """arr[slot] = val[candidate of slot] where the slot is filled."""
        v = val[src].to(arr.dtype)
        return torch.where(_bcast(fill, arr), v, arr)

    def const(arr, value):
        return torch.where(_bcast(fill, arr),
                           torch.full_like(arr, value), arr)

    M = table.max_measurements
    meas_uv = table.meas_uv.clone()
    meas_uv[:, 0] = put(table.meas_uv[:, 0], uv4)
    meas_T = table.meas_T_wc.clone()
    meas_T[:, 0] = torch.where(fill[:, None, None], T_wc.to(meas_T.dtype),
                               table.meas_T_wc[:, 0])
    uids = (next_uid + cand_rank).to(torch.int32)
    R = table.desc_hist.shape[1]
    table = table.replace(
        active=table.active | fill,
        uid=put(table.uid, uids),
        age=const(table.age, 0),
        failed=const(table.failed, 0),
        keyframe_presences=const(table.keyframe_presences, 0),
        opt_success=const(table.opt_success, 0),
        opt_failed=const(table.opt_failed, 0),
        is_optimal=table.is_optimal & ~fill,
        pos_w=put(table.pos_w, pos_w),
        uv_left_last=put(table.uv_left_last, uv_left),
        disparity_last=put(table.disparity_last, disparity),
        desc_left_ref=put(table.desc_left_ref, desc_left),
        desc_right_ref=put(table.desc_right_ref, desc_right),
        desc_left_last=put(table.desc_left_last, desc_left),
        desc_hist=put(table.desc_hist,
                      desc_left[:, None, :].expand(N, R, desc_left.shape[1])),
        hist_next=const(table.hist_next, 0),
        bit_sum=put(table.bit_sum, unpack_bits(desc_left)),
        bit_stable=const(table.bit_stable, 0.0),
        meas_uv=meas_uv,
        meas_T_wc=meas_T,
        meas_count=const(table.meas_count, 1),
        meas_next=const(table.meas_next, 1 % M),
    )
    return table, (next_uid + n_insert).to(torch.int32)


def add_measurements(
    table: LandmarkTable,
    tracked: torch.Tensor,        # [L] bool — landmarks tracked this frame
    uv4: torch.Tensor,            # [L, 4] stereo measurement
    desc_left: torch.Tensor,      # [L, 8] int32 — newly observed descriptor
    T_wc: torch.Tensor,           # [4, 4]
    hist_every: int = 8,          # snapshot cadence into the descriptor ring
) -> LandmarkTable:
    """Append a stereo measurement per tracked landmark (batched
    ``CLandmark::addMeasurement``, CLandmark.cpp:80): ring-buffer write,
    update last-seen descriptor/pixel/disparity, reset/bump failure counters
    (ref failure handling CFundamentalMatcher.cpp:1014-1025)."""
    M = table.max_measurements
    dev = table.device
    slot = table.meas_next
    # one-hot over the ring: the slot each tracked landmark writes
    write = (torch.arange(M, device=dev)[None, :] == slot[:, None]) \
        & tracked[:, None]                                       # [L, M]
    meas_uv = torch.where(write[:, :, None], uv4[:, None, :], table.meas_uv)
    meas_T = torch.where(write[:, :, None, None],
                         T_wc.to(table.meas_T_wc.dtype), table.meas_T_wc)
    disparity = uv4[:, 0] - uv4[:, 2]
    # per-bit statistics fold-in (ref CLandmark.cpp:96-124): probability
    # accumulates the new bits; permanence counts agreement with the
    # PREVIOUS observation (desc_left_last before this frame's overwrite)
    bits_new = unpack_bits(desc_left).to(table.bit_sum.dtype)
    bits_prev = unpack_bits(table.desc_left_last).to(table.bit_sum.dtype)
    agree = 1.0 - torch.abs(bits_new - bits_prev)
    # descriptor-history ring push: every hist_every-th measurement
    R = table.desc_hist.shape[1]
    push = tracked & (((table.meas_count + 1) % hist_every) == 0)
    hslot = table.hist_next
    hwrite = (torch.arange(R, device=dev)[None, :] == hslot[:, None]) \
        & push[:, None]                                          # [L, R]
    desc_hist = torch.where(hwrite[:, :, None], desc_left[:, None, :],
                            table.desc_hist)
    t2 = tracked[:, None]
    zero = torch.zeros_like(table.failed)
    return table.replace(
        desc_hist=desc_hist,
        hist_next=torch.where(push, (hslot + 1) % R, hslot),
        bit_sum=torch.where(t2, table.bit_sum + bits_new, table.bit_sum),
        bit_stable=torch.where(t2, table.bit_stable + agree, table.bit_stable),
        meas_uv=meas_uv,
        meas_T_wc=meas_T,
        meas_count=torch.where(tracked, table.meas_count + 1, table.meas_count),
        meas_next=torch.where(tracked, (slot + 1) % M, slot),
        uv_left_last=torch.where(t2, uv4[:, :2], table.uv_left_last),
        disparity_last=torch.where(tracked, disparity, table.disparity_last),
        desc_left_last=torch.where(t2, desc_left, table.desc_left_last),
        failed=torch.where(tracked, zero,
                           torch.where(table.active, table.failed + 1, zero)),
        age=torch.where(table.active, table.age + 1, table.age),
    )


def retire_landmarks(table: LandmarkTable, params) -> LandmarkTable:
    """Deactivate dead rows (ref: drop after 5 failed trackings
    CFundamentalMatcher.h:83; free landmarks not seen for 100 frames
    CFundamentalMatcher.cpp:203-242)."""
    dead = table.active & (
        (table.failed > params.max_failed_trackings)
        | ((table.age > params.stale_landmark_age_frames)
           & (table.keyframe_presences == 0))
    )
    return table.replace(active=table.active & ~dead)


def measurement_mask(table: LandmarkTable) -> torch.Tensor:
    """[L, M] bool — which ring slots hold real measurements."""
    M = table.max_measurements
    counts = torch.clamp(table.meas_count, max=M)
    return torch.arange(M, device=table.device)[None, :] < counts[:, None]


def anchor_descriptors(table: LandmarkTable) -> torch.Tensor:
    """[L, 8] — per-landmark acceptance anchor drawn from the descriptor
    history: the candidate among {creation reference, ring snapshots}
    nearest in Hamming distance to the landmark's CURRENT appearance
    (first minimum). A deliberate, opt-in deviation from the reference's
    fixed creation-descriptor gate (config.use_desc_history, OFF by
    default); with an empty ring it returns ``desc_left_ref`` exactly."""
    cands = torch.cat(
        [table.desc_left_ref[:, None, :], table.desc_hist], dim=1
    )                                                       # [L, R+1, 8]
    d = hamming_words(cands, table.desc_left_last[:, None, :])   # [L, R+1]
    best = torch.min(d, dim=1).indices
    idx = best[:, None, None].expand(-1, 1, cands.shape[2])
    return torch.gather(cands, 1, idx)[:, 0]


def bit_prob_u8(table: LandmarkTable) -> torch.Tensor:
    """[L, 256] uint8 — per-landmark descriptor bit probabilities quantized
    to 1/255 steps (``bit_sum / meas_count``)."""
    cnt = torch.clamp(table.meas_count.to(torch.float32), min=1.0)
    p = table.bit_sum / cnt[:, None]
    return torch.round(255.0 * torch.clamp(p, 0.0, 1.0)).to(torch.uint8)
