"""Point-to-plane measurement model for the iterated update.

Fuses the reference's per-iteration chain — `Mapper::match`
(Mapper.cpp:59-114: transform to world, kNN, plane fit, gate) and
`Localizer::calculate_H` (Localizer.cpp:537-577: N×12 Jacobian rows,
h = −dist) — into one batched, fixed-shape function of the current iterate.
Invalid/padded matches produce zero rows, which contribute nothing to HᵀH /
Hᵀh inside the filter.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from fast_limo_tpu.models import mapper as mp
from fast_limo_tpu.models import state as st
from fast_limo_tpu.ops import plane as plane_op
from fast_limo_tpu.ops import so3


class MatchStats(NamedTuple):
    n_matches: jnp.ndarray   # () int32


STALE_BUDGET = 128   # default per-device budget for the stale-patch branch


def window_size(k: int) -> int:
    """Frozen re-match WINDOW per query (single source: the sharded comm
    model and the loop kernel pack both key on it)."""
    return k + 7


class FrozenWindow(NamedTuple):
    """Per-query top-W candidate window, resolved once at the predicted pose
    (``glob0``), plus what the staleness certificates need."""

    glob0: jnp.ndarray      # (N,3) query points at the predicted pose
    nbrs: jnp.ndarray       # (N,W,3) window candidates
    valid: jnp.ndarray      # (N,W)
    cnt: jnp.ndarray        # (N,) valid candidates (< W: the whole cube)
    d_wmax: jnp.ndarray     # (N,) W-th distance at glob0 (+inf if partial)
    b0: jnp.ndarray         # (N,3) int32 frozen base block of the gather
    band_lo: jnp.ndarray    # (N,3) world extent of the frozen b0 band
    band_hi: jnp.ndarray    # (N,3)


def freeze_window(glob0, nbrs_w, sq_w, vld_w,
                  voxel_size: float) -> FrozenWindow:
    """Window from a top-W kNN resolve at ``glob0``: candidates ``nbrs_w``
    (N,W,3) with ascending squared distances ``sq_w`` (N,W) and validity
    ``vld_w`` (N,W)."""
    W = nbrs_w.shape[1]
    cnt = jnp.sum(vld_w, axis=-1)
    d_wmax = jnp.where(cnt >= W, jnp.sqrt(sq_w[:, W - 1]), jnp.inf)
    b0 = (mp.voxel_coords(glob0, voxel_size) - 1) >> 1
    band_lo = (b0 * 2 + 1).astype(glob0.dtype) * voxel_size
    return FrozenWindow(glob0, nbrs_w, vld_w, cnt, d_wmax, b0, band_lo,
                        band_lo + 2.0 * voxel_size)


def window_rank(win: FrozenWindow, glob, k: int):
    """Exact top-k over the frozen window at the current query points.

    Returns ``(sel_nbrs (N,k,3), sel_sq (N,k) ascending, +inf pads)``."""
    diff = glob[:, None, :] - win.nbrs                    # (N,W,3)
    d2 = jnp.where(win.valid, jnp.sum(diff * diff, -1), jnp.inf)
    neg, order = jax.lax.top_k(-d2, k)
    sel_nbrs = jnp.take_along_axis(win.nbrs, order[..., None], axis=1)
    return sel_nbrs, -neg


def stale_mask(win: FrozenWindow, glob, sel_sq, pc_valid, k: int,
               voxel_size: float):
    """Per-query certificate FAILURES: could a full re-match at ``glob``
    return a different candidate set than the window re-rank?

    cert_a (outside-window entry): every non-window candidate of the frozen
    cube had distance ≥ d_W at glob0, hence ≥ d_W − Δ now (Δ = the query's
    displacement); the selected k-th must beat that.  A partial window
    (cnt < W) holds the WHOLE cube — nothing outside.  cert_b (block
    crossing): if the query left its frozen b0 band by δ, the frozen cube
    still covers radius voxel_size − δ around it (gather_rows coverage
    guarantee) — candidates revealed by the new cube are farther than that.
    A query whose b0 is unchanged sees the identical cube (no cert_b
    needed)."""
    W = win.nbrs.shape[1]
    kth_d = jnp.sqrt(sel_sq[:, k - 1])        # inf if < k candidates
    delta = jnp.linalg.norm(glob - win.glob0, axis=-1)
    cert_a = (win.cnt < W) | (kth_d < win.d_wmax - delta)
    b0_same = jnp.all(
        ((mp.voxel_coords(glob, voxel_size) - 1) >> 1) == win.b0, axis=-1)
    leave = jnp.max(jnp.maximum(win.band_lo - glob, glob - win.band_hi),
                    axis=-1)
    cert_b = kth_d < voxel_size - jnp.maximum(leave, 0.0)
    return pc_valid & ~(cert_a & (b0_same | cert_b))


def jacobian_rows(pc, n_abcd, keep, x: st.NavState, estimate_extrinsics):
    """Point-to-plane Jacobian rows and residuals (Localizer.cpp:537-577).

    pc (N,3) baselink points, n_abcd (N,4) planes, keep (N,) →
    ``(H (N,12), h (N,))`` with zero rows where ``keep`` is False.
    """
    dtype = pc.dtype
    glob = so3.quat_rotate(x.rot, pc) + x.pos
    dist = plane_op.point_to_plane(n_abcd, glob)
    n = n_abcd[:, :3]                                     # (N,3)
    # C = Rᵀ n ; A = p_imu × C ; B = p_lidar × (R_LIᵀ C)  (Localizer.cpp:549-569)
    Rinv = so3.quat_to_mat(so3.quat_conj(x.rot))
    C = n @ Rinv.T
    A = jnp.cross(pc, C)                                  # RT⁻¹·global == local
    if estimate_extrinsics:
        RLIinv = so3.quat_to_mat(so3.quat_conj(x.rot_LI))
        p_lidar = (pc - x.t_LI) @ RLIinv.T
        B = jnp.cross(p_lidar, C @ RLIinv.T)
        H = jnp.concatenate([n, A, B, C], axis=-1)        # (N,12)
    else:
        H = jnp.concatenate([n, A, jnp.zeros_like(n), jnp.zeros_like(n)],
                            axis=-1)
    H = jnp.where(keep[:, None], H, 0.0).astype(dtype)
    h = jnp.where(keep, -dist, 0.0).astype(dtype)
    return H, h


def h_statistics(pc, n_abcd, keep, x: st.NavState, estimate_extrinsics):
    """The measurement sufficient statistics ``(HᵀH (12,12), Hᵀh (12,))``
    consumed by `iekf.update_iterated`."""
    H, h = jacobian_rows(pc, n_abcd, keep, x, estimate_extrinsics)
    return H.T @ H, H.T @ h


def make_h_model(m: mp.VoxelHashMap, pc, pc_valid, *,
                 voxel_size: float, k: int, probes: int,
                 max_dist_plane: float, plane_threshold: float,
                 max_num_matches: int, estimate_extrinsics: bool,
                 shard_axis: str = None, num_shards: int = 1,
                 query_axis: str = None, num_query_shards: int = 1,
                 knn_refresh: str = "always", x0: st.NavState = None,
                 neighborhood: int = 27, with_debug: bool = False,
                 dynamic_gate: float = 0.0, stale_budget: int = STALE_BUDGET):
    """Build the measurement closures over baselink-frame points pc.

    Returns ``(h_rows, h_stats)`` where ``h_rows(x) -> (H (Nq,12), h (Nq,))``
    gives the raw Jacobian rows (zero for invalid matches; Nq = this
    device's query slice) and ``h_stats(x) -> (HᵀH, Hᵀh)`` the sufficient
    statistics consumed by `iekf.update_iterated`.

    ``pc`` is the deskewed pc2match cloud in the baselink (Xt2) frame,
    already capped to MAX_NUM_PC2MATCH points (Mapper.cpp:63-69).

    Parallelism (both optional, composable on a 2-D mesh):
    * ``shard_axis``: the map lives sharded by hash ownership; per-shard
      kNN top-k candidates merge across devices with ``all_gather``.
    * ``query_axis``: each device matches only its 1/num_query_shards slice
      of the queries; HᵀH/Hᵀh are ``psum``-reduced — linear throughput
      scaling of the gather/fit/Jacobian work.

    ``knn_refresh``: RETIRED knob (round 5), kept for config compatibility —
    both values run the same CERTIFIED EXACT WINDOW RE-MATCH: semantics are
    the reference's "re-match every iteration" (h_share_model,
    use-ikfom.cpp:10-31), at resolve-once gather cost.  The candidate
    neighborhood is resolved ONCE at ``x0`` (the predicted pose) as a
    top-W WINDOW per query (`window_size`); every iteration then re-matches EXACTLY
    over that window — true distances at the iterate, exact top-k
    selection (so ties and reorderings cost nothing), a fresh plane fit,
    and every pose-dependent gate/cap recomputed — plus per-query
    staleness certificates proving a full re-gather could not differ:

    * outside-window entry (cert_a): every non-window candidate of the
      cube had distance ≥ d_W at x0, hence ≥ d_W − Δ at the iterate (Δ =
      that query's displacement); the selected k-th must beat that.  A
      partial window (cnt < W) holds the WHOLE cube — nothing outside.
    * block crossing (cert_b): the 8-block gather depends only on
      ``b0 = (voxel(q)−1)>>1`` (mapper.gather_rows); an unmoved b0 means
      the identical cube.  A query that left its b0 band by δ still has
      guaranteed coverage radius ``voxel_size − δ`` from the frozen cube,
      so the selection stands while the k-th distance beats it.

    Any query whose certificate fails flips that iteration to a true
    re-gather (`lax.cond`), so the semantics never degrade; measured on
    the bench scene, ~80% of scans have ZERO stale queries and the rest
    single digits (tools/probe_stale_rate.py; DebugOutput.n_stale is the
    live telemetry).

    ``with_debug=True`` additionally returns a third closure
    ``h_debug(x) -> (n_abcd (Nq,4), keep (Nq,), dist (Nq,), n_stale ())``
    — the raw match data (plane coefficients, validity, signed distances)
    behind the reference's match-marker debug publisher (src/main.cpp:203,
    ROSutils.hpp:216-252), plus the staleness telemetry.
    """
    assert knn_refresh in ("always", "first")

    if query_axis is not None:
        Nq = pc.shape[0] // num_query_shards
        qidx = jax.lax.axis_index(query_axis)
        pc = jax.lax.dynamic_slice_in_dim(pc, qidx * Nq, Nq, axis=0)
        pc_valid = jax.lax.dynamic_slice_in_dim(pc_valid, qidx * Nq, Nq, axis=0)

    def _gather(glob):
        """Raw neighborhood gather → (rows, nc, owned)."""
        if shard_axis is None:
            return mp.gather_rows(
                m, glob, voxel_size=voxel_size, neighborhood=neighborhood)
        idx = jax.lax.axis_index(shard_axis)
        return mp.gather_rows(
            m, glob, voxel_size=voxel_size, num_shards=num_shards,
            shard_index=idx, neighborhood=neighborhood)

    def _topk(gathered, glob, kk=k):
        rows, nc, owned = gathered
        cand_pts, cand_valid = mp.cands_from_rows(rows, nc, owned, m.bucket)
        nbrs, sq, vld = mp.topk_from_candidates(cand_pts, cand_valid, glob,
                                                k=kk)
        if shard_axis is None:
            return nbrs, sq, vld
        # map-sharded: per-shard top-k candidates are all_gathered and
        # re-merge into the global k nearest — identical to one device.
        nbrs_g = jax.lax.all_gather(nbrs, shard_axis)         # (D,N,kk,3)
        sq_g = jax.lax.all_gather(sq, shard_axis)             # (D,N,kk)
        N = glob.shape[0]
        sq_cat = jnp.moveaxis(sq_g, 0, 1).reshape(N, num_shards * kk)
        nbr_cat = jnp.moveaxis(nbrs_g, 0, 1).reshape(N, num_shards * kk, 3)
        neg, top = jax.lax.top_k(-sq_cat, kk)
        sq = -neg
        nbrs = jnp.take_along_axis(nbr_cat, top[..., None], axis=1)
        return nbrs, sq, jnp.isfinite(sq)

    def _dyn_gate(good, n_abcd, glob):
        """Robust residual gate (MappingConfig.DYNAMIC_GATE): movers leave
        ~v·Δt residuals against their stale map imprints, far above the
        static cm-band — reject matches beyond gate·(two-pass robust mean
        |residual|), floored at 5 cm so clean scenes never self-tighten."""
        if dynamic_gate <= 0:
            return good
        ad = jnp.abs(plane_op.point_to_plane(n_abcd, glob))
        gf = good.astype(ad.dtype)

        def _means(w):
            s, n = jnp.sum(ad * w), jnp.sum(w)
            if query_axis is not None:
                s = jax.lax.psum(s, query_axis)
                n = jax.lax.psum(n, query_axis)
            return s / jnp.maximum(n, 1.0)

        m1 = _means(gf)
        m2v = _means(gf * (ad <= 3.0 * m1 + 0.05))
        return good & (ad <= jnp.maximum(dynamic_gate * m2v, 0.05))

    def _cap(good):
        """MAX_NUM_MATCHES cap in point order (Localizer.cpp:539); with
        query sharding the cap needs the exclusive prefix of lower shards."""
        local_cum = jnp.cumsum(good.astype(jnp.int32))
        if query_axis is not None:
            totals = jax.lax.all_gather(local_cum[-1], query_axis)  # (D,)
            qidx = jax.lax.axis_index(query_axis)
            prefix = jnp.sum(jnp.where(
                jnp.arange(num_query_shards) < qidx, totals, 0))
            local_cum = local_cum + prefix
        return good & (local_cum <= max_num_matches)

    def _match(glob):
        """FULL re-match: kNN gather + plane fit + gates at the given pose
        (the certificate-failure fallback — exact by construction)."""
        nbrs, sq, vld = _topk(_gather(glob), glob)
        n_abcd, good = plane_op.fit_planes(
            nbrs, sq, vld, num_match_points=k,
            max_dist_plane=max_dist_plane, plane_threshold=plane_threshold)
        good = _dyn_gate(good & pc_valid, n_abcd, glob)
        return n_abcd, _cap(good)

    # ---- ONE frozen resolve at the predicted pose (see docstring) ----
    assert x0 is not None, "make_h_model needs the predicted pose x0"
    # Candidate WINDOW per query: the re-rank is EXACT inside the window
    # (true distances, refit), so ties and near-boundary reorderings cost
    # nothing; only a candidate from OUTSIDE the window entering the top-k
    # (gap d_W − d_k, rarely < the iterate's displacement) or a
    # sparse-region block crossing marks a query stale.  At k+3 the
    # d_W − d_k gap still lost the certificate on about half the bench scans
    # (1-5 near-tie queries of 10k); k+7 widens it to rarely-beaten range.
    W = window_size(k)
    glob0 = so3.quat_rotate(x0.rot, pc) + x0.pos
    win = freeze_window(glob0, *_topk(_gather(glob0), glob0, kk=W),
                        voxel_size=voxel_size)

    # the patch budget cannot exceed the (per-shard) query count — top_k
    # with k > axis size is a trace-time error, and BOTH cond branches are
    # always traced even on configs where nothing is ever stale
    budget = min(int(stale_budget), int(pc.shape[0]))

    def _window_fit(glob, ranked):
        """Fresh fit over the pre-ranked window selection (no
        pc_valid/dynamic/cap yet)."""
        sel_nbrs, sel_sq = ranked
        return plane_op.fit_planes(
            sel_nbrs, sel_sq, jnp.isfinite(sel_sq), num_match_points=k,
            max_dist_plane=max_dist_plane, plane_threshold=plane_threshold)

    def _finish(n_abcd, good, glob):
        good = _dyn_gate(good & pc_valid, n_abcd, glob)
        return n_abcd, _cap(good)

    def _window_match(args):
        """EXACT re-match over the window: true top-k, fresh plane fit,
        every gate recomputed at the current pose."""
        glob, ranked, _stale = args
        return _finish(*_window_fit(glob, ranked), glob)

    def _patched_match(args):
        """Window re-match with the ≤ budget certificate-failed queries
        FULLY re-resolved (fresh 8-block gather + top-k + fit at the
        current pose) and merged — exact at a fraction of the full
        re-gather's cost when only a handful of queries are stale."""
        glob, ranked, stale = args
        n_w, good_w = _window_fit(glob, ranked)
        _v, idx = jax.lax.top_k(stale.astype(jnp.float32), budget)
        sel_ok = _v > 0.5                       # padded picks are non-stale
        qg = glob[idx]
        nbrs_s, sq_s, vld_s = _topk(_gather(qg), qg, kk=k)
        n_s, good_s = plane_op.fit_planes(
            nbrs_s, sq_s, vld_s, num_match_points=k,
            max_dist_plane=max_dist_plane, plane_threshold=plane_threshold)
        n_m = n_w.at[idx].set(jnp.where(sel_ok[:, None], n_s, n_w[idx]))
        good_m = good_w.at[idx].set(jnp.where(sel_ok, good_s, good_w[idx]))
        return _finish(n_m, good_m, glob)

    def _rematch(glob):
        """Per-iteration exact re-match: window fast path; the rare
        certificate failures (see stale_mask) patch just the stale
        queries; a full re-gather only when they exceed the budget."""
        ranked = window_rank(win, glob, k)
        stale = stale_mask(win, glob, ranked[1], pc_valid, k, voxel_size)
        # dtype pinned: under x64 test mode jnp.sum would promote to int64
        # and double the certificate psum's wire size (comm_volume models 4 B)
        local_viol = jnp.sum(stale.astype(jnp.int32), dtype=jnp.int32)
        if query_axis is not None:
            viol = jax.lax.psum(local_viol, query_axis)
            # the branch predicates must AGREE across devices (both inner
            # branches run collectives): budget on the WORST shard
            over = jax.lax.pmax(local_viol, query_axis)
        else:
            viol = local_viol
            over = local_viol
        # the ranked selection rides into the branches as an operand — XLA
        # cannot CSE across the cond boundary, so recomputing it inside
        # would double the dominant (N,W) distance + top_k work per eval
        return jax.lax.cond(
            viol == 0, _window_match,
            lambda args: jax.lax.cond(
                over <= budget, _patched_match,
                lambda a: _match(a[0]), args),
            (glob, ranked, stale))

    def h_rows(x: st.NavState):
        # world-frame query points under the current iterate (Mapper.cpp:71-72)
        glob = so3.quat_rotate(x.rot, pc) + x.pos
        n_abcd, keep = _rematch(glob)
        return jacobian_rows(pc, n_abcd, keep, x, estimate_extrinsics)

    def h_stats(x: st.NavState):
        H, h = h_rows(x)
        HTH, HTh = H.T @ H, H.T @ h
        if query_axis is not None:
            HTH = jax.lax.psum(HTH, query_axis)
            HTh = jax.lax.psum(HTh, query_axis)
        return HTH, HTh

    if not with_debug:
        return h_rows, h_stats

    def h_debug(x: st.NavState):
        glob = so3.quat_rotate(x.rot, pc) + x.pos
        n_abcd, keep = _rematch(glob)
        dist = plane_op.point_to_plane(n_abcd, glob)
        # staleness telemetry at this iterate: how many queries' window
        # certificates fail (each forces the exact re-gather path) —
        # observability for the re-match design
        _sel, sel_sq = window_rank(win, glob, k)
        n_stale = jnp.sum(
            stale_mask(win, glob, sel_sq, pc_valid, k, voxel_size).astype(
                jnp.int32), dtype=jnp.int32)
        if query_axis is not None:
            # pc was sliced to this device's query shard above, so the match
            # leaves are shard-local — but DebugOutput is declared replicated
            # in the sharded step's out_specs.  Reassemble the full query
            # axis (shards were contiguous slices, so concatenation in
            # shard order restores the original point order).
            def unshard(a):
                g = jax.lax.all_gather(a, query_axis)     # (D, Nq, ...)
                return g.reshape((-1,) + g.shape[2:])

            n_abcd, keep, dist = unshard(n_abcd), unshard(keep), unshard(dist)
            n_stale = jax.lax.psum(n_stale, query_axis)
        return n_abcd, keep, dist, n_stale

    return h_rows, h_stats, h_debug
