"""Exclusive Feature Bundling (EFB) for wide sparse frames.

Wide one-hot frames spend the histogram build on columns that are
almost all at one bin. EFB (LightGBM's, the JAX package's
``models/tree/efb.py``) packs mutually exclusive sparse features —
features whose non-default rows never overlap — into single columns, so
the binned matrix and every level's histogram run at the bundled width
Fb instead of F.

- The bundled matrix is for training only. Split finding decodes every
  winning slot back to the original (feature, bin) before the tree is
  written (``core._find_splits_efb``), so trees, flattened trees,
  artifacts and serving never see a bundle.
- A bundle column's slots: slot 0 is "every member at its default bin";
  each member owns a contiguous run — one slot per non-default body bin
  seen in the data, one empty slot for its default bin (so the cut at
  the default stays a candidate), and one NA slot. Bin B-1 stays unused,
  so the node totals come out as in the unbundled matrix.
- Dense features pass through with their original codes: their gains
  are the unbundled ones.
- A member's default-bin mass is the node total minus the member's own
  slots: exact under zero conflicts, so bundled trains are bitwise the
  unbundled ones where the sums are exact (integer counts, dyadic
  gradients) and within f32 rounding elsewhere.
- ``H2O_TPU_EFB_CONFLICT`` (a fraction of rows, default 0) lets members
  of one bundle share rows, the first member winning; the plan is
  verified on the full data and a member past the budget is demoted to
  its own column, so a plan built on a sample never drops rows.

``H2O_TPU_EFB=0`` turns it off; ``auto`` (the default) plans frames of
at least ``H2O_TPU_EFB_MIN_F`` features (64) and keeps a plan when
Fb <= ``H2O_TPU_EFB_MIN_SHRINK`` · F (0.75); ``1`` plans at any width
and keeps any shrink.

The port keeps the binned matrix feature-major: the plan's host matrix
is [Fb, rows] uint8 (the JAX package's transposed), and ``EFBLuts`` are
torch tensors on the frame's device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .binning import fit_bins, host_codes_block

__all__ = ["efb_mode", "conflict_budget_frac", "efb_eligible", "EFBLuts",
           "EFBPlan", "plan_bundles", "fit_plan_cached", "chunk_plan_host"]

# sample rows the greedy planner sees (the full data re-verifies the
# plan, demoting any member the sample misjudged)
_PLAN_SAMPLE = 1 << 16
# a feature may be bundled when at most this fraction of the sample is
# off its default bin ...
_MAX_DENSITY = 0.3
# ... and its slots (non-default body bins, the default slot, the NA
# slot) leave room for at least 4 members per bundle
_MAX_SLOT_FRAC = 4
# open bundles the greedy pass tries per feature before opening another
_MAX_BUNDLE_TRIES = 64

_POPCNT8 = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def efb_mode() -> str:
    """H2O_TPU_EFB: '0' off, '1' force, anything else (default) auto."""
    v = os.environ.get("H2O_TPU_EFB", "auto")
    return v if v in ("0", "1") else "auto"


def conflict_budget_frac() -> float:
    """H2O_TPU_EFB_CONFLICT: the fraction of rows a bundle's members
    may share (default 0, exact exclusivity)."""
    try:
        return max(0.0, float(os.environ.get("H2O_TPU_EFB_CONFLICT", "0")))
    except ValueError:
        return 0.0


def efb_eligible(n_features: int, checkpoint) -> bool:
    """Whether a train plans bundles at all: never under
    ``H2O_TPU_EFB=0`` or a checkpoint continuation (whose trees descend
    the checkpoint's unbundled matrix); with ``1`` at 2 features or
    more; in auto mode at ``H2O_TPU_EFB_MIN_F`` (64) or more."""
    mode = efb_mode()
    if mode == "0" or checkpoint is not None:
        return False
    if mode == "1":
        return n_features >= 2
    min_f = int(os.environ.get("H2O_TPU_EFB_MIN_F", "64"))
    return n_features >= max(min_f, 2)


def _keep_plan(F: int, fb: int) -> bool:
    if fb >= F:
        return False
    if efb_mode() == "1":
        return True
    try:
        shrink = float(os.environ.get("H2O_TPU_EFB_MIN_SHRINK", "0.75"))
    except ValueError:
        shrink = 0.75
    return fb <= shrink * F


class EFBLuts(NamedTuple):
    """The tables the tree core decodes bundles with, on the frame's
    device. B is the bin count, Fb the bundled width, F the original
    one; a column has S = B-1 candidate slots."""

    slot_feat: torch.Tensor     # int32 [Fb, B] original feature per slot, -1 none
    slot_bin: torch.Tensor      # int32 [Fb, B] original bin per slot (B-1 = NA)
    na_slot: torch.Tensor       # int32 [Fb, B] the slot's member's NA slot
    mstart: torch.Tensor        # int32 [Fb, B] the member's first body slot
    mend: torch.Tensor          # int32 [Fb, B] the member's last body slot
    has_rem: torch.Tensor       # bool  [Fb, B] the default remainder applies
    dbin: torch.Tensor          # int32 [Fb, B] the member's default bin
    perm: torch.Tensor          # int32 [Fb*(B-1)] candidate rank -> flat slot,
    #                             by (original feature, bin), so argmax ties
    #                             break as in the unbundled flat order
    feat_col: torch.Tensor      # int32 [F] bundled column of each feature
    feat_default: torch.Tensor  # int32 [F] default bin (0 for passthrough)


@dataclass
class _Member:
    feat: int
    default_bin: int
    slot_of_code: np.ndarray       # [B] uint8 code -> slot (255 unmapped)
    body: list                     # [(slot, orig_bin)] ascending orig bin
    na_slot: int


@dataclass
class EFBPlan:
    """A bundling plan and its bundled matrix: [Fb, rows] uint8 on the
    host until the device copy is made, then on the device only."""

    n_features: int
    n_bins: int
    cols: list                      # ("pass", feat) | ("bundle", [_Member])
    binned_host: np.ndarray | None  # [Fb, rows] uint8
    conflicts: int                  # rows resolved first-member-wins
    demoted: list = field(default_factory=list)   # features that failed
    device: torch.device = torch.device("cpu")
    _luts: EFBLuts | None = None
    _binned_dev: torch.Tensor | None = None

    @property
    def fb(self) -> int:
        return len(self.cols)

    def device_luts(self) -> EFBLuts:
        if self._luts is None:
            self._luts = _build_luts(self)
        return self._luts

    def binned_device(self) -> torch.Tensor:
        """The bundled [Fb, rows] matrix on the plan's device, made once
        and cached on the plan. The host copy is released then: the
        unbundled path keeps no host matrix either."""
        if self._binned_dev is None:
            self._binned_dev = torch.as_tensor(self.binned_host,
                                               device=self.device)
            self.binned_host = None
        return self._binned_dev

    def host_matrix(self) -> np.ndarray:
        """[Fb, rows] uint8 on the host: the kept host copy, or the
        device copy fetched back."""
        if self.binned_host is not None:
            return self.binned_host
        return self._binned_dev.cpu().numpy()


def _build_luts(plan: EFBPlan) -> EFBLuts:
    B = plan.n_bins
    Fb = plan.fb
    F = plan.n_features
    slot_feat = np.full((Fb, B), -1, dtype=np.int32)
    slot_bin = np.full((Fb, B), B - 1, dtype=np.int32)
    na_slot = np.full((Fb, B), B - 1, dtype=np.int32)
    mstart = np.zeros((Fb, B), dtype=np.int32)
    mend = np.full((Fb, B), B - 2, dtype=np.int32)
    has_rem = np.zeros((Fb, B), dtype=bool)
    dbin = np.zeros((Fb, B), dtype=np.int32)
    feat_col = np.zeros(F, dtype=np.int32)
    feat_default = np.zeros(F, dtype=np.int32)
    for c, (kind, payload) in enumerate(plan.cols):
        if kind == "pass":
            # the column IS the original feature: mstart 0, mend B-2, NA
            # B-1 and no remainder reduce to the unbundled cumsum
            feat_col[payload] = c
            slot_feat[c, :] = payload
            slot_bin[c, :] = np.arange(B)
            continue
        for m in payload:
            feat_col[m.feat] = c
            feat_default[m.feat] = m.default_bin
            lo, hi = m.body[0][0], m.body[-1][0]
            for s in [s for s, _ in m.body] + [m.na_slot]:
                slot_feat[c, s] = m.feat
                na_slot[c, s] = m.na_slot
                mstart[c, s] = lo
                mend[c, s] = hi
                has_rem[c, s] = True
                dbin[c, s] = m.default_bin
            for s, ob in m.body:
                slot_bin[c, s] = ob
            slot_bin[c, m.na_slot] = B - 1
    # candidates (slots < B-1) ranked by (original feature, original
    # bin, column, slot), invalid ones last: the argmax over the
    # permuted gains picks the unbundled flat argmax's winner, ties too
    S = B - 1
    sf = slot_feat[:, :S].ravel()
    sb = slot_bin[:, :S].ravel()
    valid = (sf >= 0) & (sb < B - 1)
    perm = np.lexsort((np.arange(Fb * S), np.where(valid, sb, B),
                       np.where(valid, sf, F)))
    dev = plan.device
    return EFBLuts(*(torch.as_tensor(a, device=dev) for a in (
        slot_feat, slot_bin, na_slot, mstart, mend, has_rem, dbin,
        perm.astype(np.int32), feat_col, feat_default)))


def _pack(mask: np.ndarray) -> np.ndarray:
    return np.packbits(mask)


def _overlap(packed_a: np.ndarray, packed_b: np.ndarray) -> int:
    return int(_POPCNT8[np.bitwise_and(packed_a, packed_b)].sum())


def _feature_stats(stats, j: int, codes: np.ndarray, B: int, ns: int,
                   cap_slots: int) -> None:
    """Bundling statistics of one sampled column: its default (the
    most used body bin), its non-default row mask and its slot need;
    nothing for an all-NA, dense or many-valued column."""
    counts = np.bincount(codes, minlength=B)
    default = int(np.argmax(counts[: B - 1]))          # body bins only
    if counts[default] <= 0:
        return
    nnd = codes != default
    n_nnd = int(nnd.sum())
    if n_nnd > _MAX_DENSITY * ns:
        return
    used_body = np.nonzero(counts[: B - 1])[0]
    used_body = used_body[used_body != default]
    if len(used_body) + 2 > cap_slots:       # + the default and NA slots
        return
    stats[j] = (default, used_body, n_nnd, _pack(nnd))


def plan_bundles(frame, spec, nrows: int | None = None) -> EFBPlan | None:
    """Greedy bundling and the bundled matrix, or None when bundling
    does not pay (no exclusive sets, or the shrink gate refuses).

    1. On a sample of at most ``_PLAN_SAMPLE`` rows: each feature's
       default bin, used bins and non-default rows; eligible features,
       densest first, go into the first open bundle with slots to spare
       whose claimed rows they overlap within the conflict budget.
    2. On all rows: bin each bundle's members, verify the budget and the
       slot map against the full data (demoting a violator to its own
       column) and write the slots into the bundle column.
    Columns are binned ``binning._CODES_BLOCK`` at a time on the
    frame's device and copied to the host."""
    F = len(spec.names)
    B = spec.n_bins
    rows = frame.nrows
    n_real = rows if nrows is None else nrows
    ns = min(n_real, _PLAN_SAMPLE)
    if ns < 1 or F < 2:
        return None
    cap_slots = max(2, (B - 2) // _MAX_SLOT_FRAC)

    stats = {}           # feat -> (default_bin, used_body, nnd_count, packed)
    for lo in range(0, F, 128):
        js = list(range(lo, min(lo + 128, F)))
        codes_blk = host_codes_block(frame, spec, js, rows=ns)
        for bi, j in enumerate(js):
            _feature_stats(stats, j, codes_blk[bi], B, ns, cap_slots)
    if len(stats) < 2:
        return None
    budget = int(conflict_budget_frac() * ns)
    order = sorted(stats, key=lambda j: (-stats[j][2], j))
    bundles = []
    for j in order:
        default, used_body, n_nnd, packed = stats[j]
        need = len(used_body) + 2
        for b in bundles[:_MAX_BUNDLE_TRIES]:
            if b["slots_used"] + need > B - 2:
                continue
            ov = _overlap(b["claimed"], packed)
            if b["conflicts"] + ov > budget:
                continue
            b["members"].append(j)
            b["slots_used"] += need
            b["conflicts"] += ov
            b["claimed"] = np.bitwise_or(b["claimed"], packed)
            break
        else:
            bundles.append({"members": [j], "slots_used": 1 + need,
                            "claimed": packed.copy(), "conflicts": 0})
    bundles = [b for b in bundles if len(b["members"]) >= 2]
    if not bundles:
        return None

    full_budget = int(conflict_budget_frac() * n_real)
    built = []
    demoted: list[int] = []
    bundled_feats: set[int] = set()
    total_conflicts = 0
    for b in bundles:
        buf = np.zeros(rows, dtype=np.uint8)           # slot 0 = default
        members: list[_Member] = []
        next_slot = 1
        conflicts = 0
        codes_blk = host_codes_block(frame, spec, b["members"])
        for mi, j in enumerate(b["members"]):
            default, used_body, _, _ = stats[j]
            codes = codes_blk[mi]
            # the used non-default body bins ascending with the (empty)
            # default slot in its sorted place, then the NA slot
            bins_sorted = np.sort(
                np.concatenate([used_body, [default]])).astype(np.int64)
            slot_of_code = np.full(B, 255, dtype=np.uint8)
            body = []
            for k, ob in enumerate(bins_sorted):
                body.append((next_slot + k, int(ob)))
                slot_of_code[ob] = next_slot + k
            na_slot = next_slot + len(bins_sorted)
            slot_of_code[B - 1] = na_slot
            real = codes[:n_real]
            nnd_full = real != default
            unmapped = int((slot_of_code[real] == 255).sum())
            ov = int((nnd_full & (buf[:n_real] != 0)).sum())
            if unmapped > 0 or conflicts + ov > full_budget:
                # the sample misjudged it (unseen bins, or conflicts
                # past the budget): its own column, never dropped rows
                demoted.append(j)
                continue
            write = nnd_full & (buf[:n_real] == 0)    # first member wins
            buf[:n_real][write] = slot_of_code[real[write]]
            conflicts += ov
            members.append(_Member(feat=j, default_bin=default,
                                   slot_of_code=slot_of_code, body=body,
                                   na_slot=na_slot))
            next_slot = na_slot + 1
        if len(members) >= 2:
            built.append((members, buf))
            bundled_feats.update(m.feat for m in members)
            total_conflicts += conflicts
        else:
            demoted.extend(m.feat for m in members)
    if not built:
        return None

    fb = (F - len(bundled_feats)) + len(built)
    if not _keep_plan(F, fb):
        return None
    # passthrough columns first in original order (an all-dense prefix
    # keeps the node totals bitwise the unbundled ones), then the
    # bundles by their smallest member
    cols: list = [("pass", j) for j in range(F) if j not in bundled_feats]
    built.sort(key=lambda mb: min(m.feat for m in mb[0]))
    out = np.zeros((fb, rows), dtype=np.uint8)
    if cols:
        out[: len(cols)] = host_codes_block(frame, spec,
                                            [j for _, j in cols])
    plan_cols = list(cols)
    for members, buf in built:
        out[len(plan_cols)] = buf
        plan_cols.append(("bundle", members))
    return EFBPlan(n_features=F, n_bins=B, cols=plan_cols, binned_host=out,
                   conflicts=total_conflicts, demoted=sorted(demoted),
                   device=frame.device)


def fit_plan_cached(frame, feature_names, n_bins: int):
    """(BinSpec, EFBPlan or None), cached on the frame under the names,
    the bins, the content version and every gate knob (changing a knob
    takes effect on the next train), so a second train on the frame
    pays neither the quantile fit nor the planning."""
    key = ("efb", tuple(feature_names), n_bins, frame._version,
           conflict_budget_frac(), efb_mode(),
           os.environ.get("H2O_TPU_EFB_MIN_SHRINK", "0.75"))
    hit = frame._binned_cache.get(key)
    if hit is None:
        spec = fit_bins(frame, list(feature_names), n_bins=n_bins)
        hit = (spec, plan_bundles(frame, spec))
        frame.cache_put(key, hit)
    return hit


def chunk_plan_host(plan: EFBPlan, chunk_rows: int,
                    pin_memory: bool = False) -> list[torch.Tensor]:
    """The bundled host matrix cut into the out-of-core chunk grid of
    ``binning.bin_frame_host_chunks``: chunk c holds rows
    [c·chunk_rows, (c+1)·chunk_rows) as its own contiguous [Fb,
    chunk_rows] uint8 tensor, the last one padded with dead rows
    (slot 0)."""
    host = plan.host_matrix()
    fb, rows = host.shape
    n_chunks = -(-rows // chunk_rows)
    bufs = []
    for c in range(n_chunks):
        lo = c * chunk_rows
        hi = min(lo + chunk_rows, rows)
        buf = torch.zeros((fb, chunk_rows), dtype=torch.uint8,
                          pin_memory=pin_memory)
        buf[:, : hi - lo] = torch.from_numpy(
            np.ascontiguousarray(host[:, lo:hi]))
        bufs.append(buf)
    return bufs
