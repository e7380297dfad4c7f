"""End-to-end NumPy float64 oracle of the per-scan LIO pipeline.

`tests/oracle.py` transcribes the reference's *filter* math (IKFoM predict /
iterated update).  This module extends it to the FULL per-scan path of
`fast_limo_tpu.models.pipeline.build_scan_step`:

    IMU→baselink + intrinsics → sequential f64 predicts → preprocessing
    filters + time sort (Localizer.cpp:262-321,740-805) → deskew
    (Localizer.cpp:733-853) → voxel-grid downsample → kNN + plane fit +
    gates (Mapper.cpp:59-114, Plane.cpp:80-114) → iterated update
    (esekfom.hpp:1620-1823) → map insert (Mapper::add).

It is written in plain vectorized NumPy float64 with INDEPENDENT method
choices where they exist (sequential predicts vs the pipeline's
associative-scan; lstsq-style normal-equation plane solve vs the adjugate
kernel; dict/array map vs the fused hash table), so agreement with the f32
JAX pipeline over a trajectory is evidence that both implement the same
algorithm and the f32 device path introduces only rounding-level error.

The map model mirrors the ENGINE's documented spec — BLOCK-addressed
voxel-hash with ROW_E=16-entry groups keyed on the 2×2×2-voxel block
coordinate, per-voxel capacity B, group-full voxel rejection, and batch
insert ordering by (group, packed-key, index) — because that IS the
array-program redesign of the reference octree (see models/mapper.py docstring;
the octree itself cannot be the oracle for a voxel-hash map).  kNN
candidates are the 4³-voxel superset spanned by the 8 gathered blocks
(⊇ the reference's 27-cube coverage).

Consumed by tests/test_e2e_oracle.py.
"""

from __future__ import annotations

import numpy as np

import oracle

ROW_E = 16  # entries per hash group (models/mapper.py module constant)


# ---------------------------------------------------------------------------
# batched quaternion helpers (f64; conventions of tests/oracle.py)
# ---------------------------------------------------------------------------

def qmul_b(q, p):
    w1, x1, y1, z1 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    w2, x2, y2, z2 = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def qrot_b(q, v):
    """Rotate (...,3) vectors by (...,4) quaternions."""
    uv = np.cross(q[..., 1:], v)
    uuv = np.cross(q[..., 1:], uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def exp_quat_b(v, scale=0.5):
    """Batched MTK::exp (mtkmath.hpp:249-256) — half-angle quaternion."""
    norm2 = np.sum(v * v, axis=-1)
    x2 = scale * scale * norm2
    eps4 = np.sqrt(np.sqrt(np.finfo(np.float64).eps))
    x = np.sqrt(np.maximum(x2, 1e-300))
    c_big, s_big = np.cos(x), np.sin(x) / x
    c_small = 1.0 - x2 / 2.0 * (1.0 - x2 / 12.0)
    s_small = 1.0 - x2 / 6.0 * (1.0 - x2 / 20.0)
    big = x2 >= eps4
    c = np.where(big, c_big, c_small)
    s = np.where(big, s_big, s_small)
    return np.concatenate([c[..., None], (s * scale)[..., None] * v], axis=-1)


# ---------------------------------------------------------------------------
# voxel-hash map oracle
# ---------------------------------------------------------------------------

def _hash_groups(vc, groups):
    """int32-wraparound spatial hash (models/mapper.py:_hash)."""
    h = ((vc[..., 0] * 73856093) & 0xFFFFFFFF) \
        ^ ((vc[..., 1] * 19349669) & 0xFFFFFFFF) \
        ^ ((vc[..., 2] * 83492791) & 0xFFFFFFFF)
    return h & (groups - 1)


_KOFF = 1 << 20


def _pack_key(vc):
    """Collision-free int64 key of voxel coords (|coord| < 2^20)."""
    return (((vc[..., 0] + _KOFF) << 42)
            | ((vc[..., 1] + _KOFF) << 21)
            | (vc[..., 2] + _KOFF))


class OracleMap:
    """Dict-of-buckets mirror of models/mapper.VoxelHashMap semantics."""

    def __init__(self, capacity: int, bucket: int):
        assert capacity % ROW_E == 0
        self.groups = capacity // ROW_E
        self.bucket = bucket
        self.entries: dict = {}       # voxel tuple -> list of points (≤ B)
        self.group_n: dict = {}       # group id -> #entries taken
        self.num_points = 0
        self._snap = None

    def insert(self, pts: np.ndarray):
        """Batch insert (models/mapper.py:insert semantics).

        pts are VOXEL-quantizable world points; claiming order of new voxels
        inside a group is (packed 10-bit key, original index), matching the
        device's two-key sort; a full group rejects new voxels; a full
        bucket rejects new points (octree leaf downsampling analog).
        """
        if len(pts) == 0:
            return
        vc = np.floor(pts / self.voxel_size).astype(np.int64)
        g = _hash_groups(vc >> 1, self.groups)     # block-addressed groups
        packed = (((vc[:, 0] & 0x3FF) << 20) | ((vc[:, 1] & 0x3FF) << 10)
                  | (vc[:, 2] & 0x3FF))
        order = np.lexsort((np.arange(len(pts)), packed, g))
        placed = 0
        for i in order:
            key = (int(vc[i, 0]), int(vc[i, 1]), int(vc[i, 2]))
            lst = self.entries.get(key)
            if lst is None:
                gi = int(g[i])
                if self.group_n.get(gi, 0) >= ROW_E:
                    continue                      # group full: voxel rejected
                lst = []
                self.entries[key] = lst
                self.group_n[gi] = self.group_n.get(gi, 0) + 1
            if len(lst) < self.bucket:
                lst.append(np.array(pts[i], np.float64))
                placed += 1
        self.num_points += placed
        self._snap = None

    def _snapshot(self):
        """Arrays for vectorized lookup: sorted keys + padded buckets."""
        if self._snap is not None:
            return self._snap
        B = self.bucket
        if not self.entries:
            self._snap = (np.zeros(0, np.int64), np.zeros((1, B, 3)),
                          np.zeros(1, np.int64))
            return self._snap
        keys, ptss, cnts = [], [], []
        for (vx, vy, vz), lst in self.entries.items():
            keys.append(_pack_key(np.array([vx, vy, vz], np.int64)))
            buf = np.zeros((B, 3))
            buf[:len(lst)] = np.asarray(lst)
            ptss.append(buf)
            cnts.append(len(lst))
        keys = np.asarray(keys, np.int64)
        srt = np.argsort(keys)
        self._snap = (keys[srt], np.asarray(ptss)[srt],
                      np.asarray(cnts, np.int64)[srt])
        return self._snap

    def knn(self, queries: np.ndarray, k: int):
        """Block-neighborhood bounded kNN, ascending squared distances.

        Candidate voxels are the 4³ region spanned by the 8 blocks
        {floor((v-1)/2)+{0,1}}³ — the exact voxel set the engine's 8-block
        row gather covers (⊇ the 27-cube).
        Returns (nbrs (N,k,3), sq (N,k) with +inf pads, valid (N,k)).
        """
        keys, ptss, cnts = self._snapshot()
        N = len(queries)
        B = self.bucket
        vc = np.floor(queries / self.voxel_size).astype(np.int64)
        b0 = (vc - 1) >> 1                                    # base block
        d = np.arange(4, dtype=np.int64)
        off = np.stack(np.meshgrid(d, d, d, indexing="ij"),
                       axis=-1).reshape(64, 3)                # (64,3)
        nc = 2 * b0[:, None, :] + off[None, :, :]             # (N,64,3)
        kk = _pack_key(nc)                                    # (N,64)
        if len(keys) == 0:
            return (np.zeros((N, k, 3)), np.full((N, k), np.inf),
                    np.zeros((N, k), bool))
        pos = np.searchsorted(keys, kk)
        pos_c = np.clip(pos, 0, len(keys) - 1)
        hit = keys[pos_c] == kk                               # (N,64)
        row = np.where(hit, pos_c, 0)
        cand = ptss[row]                                      # (N,64,B,3)
        cval = hit[..., None] & (np.arange(B)[None, None, :] < cnts[row][..., None])
        cand = cand.reshape(N, 64 * B, 3)
        cval = cval.reshape(N, 64 * B)
        d2 = np.sum((cand - queries[:, None, :]) ** 2, axis=-1)
        d2 = np.where(cval, d2, np.inf)
        idx = np.argsort(d2, axis=1)[:, :k]
        sq = np.take_along_axis(d2, idx, axis=1)
        nbrs = np.take_along_axis(cand, idx[..., None], axis=1)
        return nbrs, sq, np.isfinite(sq)


# ---------------------------------------------------------------------------
# plane fit + gates (Plane.cpp:80-114 semantics; ops/plane.py contract)
# ---------------------------------------------------------------------------

def fit_planes(nbrs, sq, vld, *, k, max_dist_plane, plane_threshold):
    """Centroid-PCA plane fit with the reference gates (ops/plane.py
    contract), via np.linalg.eigh — an independent method from the engine's
    closed-form trigonometric eigensolver."""
    n_valid = vld.sum(axis=-1)
    enough = n_valid >= k
    close = sq[:, k - 1] < max_dist_plane

    w = vld[..., None].astype(float)
    nw = np.maximum(w.sum(axis=1), 1.0)
    c = (nbrs * w).sum(axis=1) / nw
    qv = (nbrs - c[:, None, :]) * w
    M = np.einsum("nki,nkj->nij", qv, qv)
    evals, evecs = np.linalg.eigh(M)                    # ascending
    lmin, lmid = evals[:, 0], evals[:, 1]
    n_unit = evecs[:, :, 0]
    ok = np.ones(len(nbrs), bool)

    d = -np.sum(n_unit * c, axis=-1)
    flip = np.where(d < 0, -1.0, 1.0)
    n_unit = n_unit * flip[:, None]
    d = d * flip

    res = np.einsum("nki,ni->nk", qv, n_unit)
    res_ok = np.all(np.where(vld, np.abs(res) <= plane_threshold, True), axis=-1)
    spread_ok = lmid > nw[:, 0] * plane_threshold ** 2
    good = enough & close & ok & res_ok & spread_ok
    return np.concatenate([n_unit, d[:, None]], axis=1), good


# ---------------------------------------------------------------------------
# the per-scan oracle
# ---------------------------------------------------------------------------

class OracleLIO:
    """f64 replica of build_scan_step_packed, fed the SAME packed arrays the
    Localizer sends to the device (record them with a subclass)."""

    def __init__(self, cfg, x0: dict, P0: np.ndarray, last_prop_time: float):
        self.cfg = cfg
        self.x = oracle.state_copy(x0)
        self.P = np.array(P0, np.float64)
        self.map = OracleMap(cfg.tpu.map_capacity, cfg.map_points_per_voxel)
        self.map.voxel_size = float(cfg.map_voxel_size)
        self.prev_scan_stamp = 0.0
        self.last_prop_time = float(last_prop_time)
        self.last_w_raw_bl = np.zeros(3)
        self.last_w = np.zeros(3)
        self.last_a = np.zeros(3)
        self.bias_gyro_corr = np.array(self.x["bg"])
        self.bias_accel_corr = np.array(self.x["ba"])

        self.R_imu2bl = np.array(cfg.extrinsics.imu2baselink_R,
                                 np.float64).reshape(3, 3).T
        self.t_imu2bl = np.asarray(cfg.extrinsics.imu2baselink_t, np.float64)
        self.sm = np.array(cfg.intrinsics.imu_sm, np.float64).reshape(3, 3)
        ik = cfg.ikfom
        self.Q = np.diag(np.concatenate([
            np.full(3, ik.cov_gyro), np.full(3, ik.cov_acc),
            np.full(3, ik.cov_bias_gyro), np.full(3, ik.cov_bias_acc)]))

    # ---- stages ------------------------------------------------------
    def _imu_chain(self, imu_pack):
        """baselink transform + intrinsics + sequential f64 predicts."""
        n_imu = int(imu_pack[1, 7])
        stamps = imu_pack[:n_imu, 6].astype(np.float64)
        acc = imu_pack[:n_imu, 0:3].astype(np.float64)
        gyro = imu_pack[:n_imu, 3:6].astype(np.float64)

        prev = np.concatenate([[self.last_prop_time], stamps[:-1]])
        dt = stamps - prev
        dt = np.where((dt <= 0.0) | (dt > 0.1), 1.0 / 200.0, dt)

        w_bl = gyro @ self.R_imu2bl.T
        w_prev = np.concatenate([self.last_w_raw_bl[None], w_bl[:-1]], axis=0)
        a_bl = acc @ self.R_imu2bl.T
        lever = -self.t_imu2bl
        a_bl = (a_bl + np.cross((w_bl - w_prev) / dt[:, None],
                                np.broadcast_to(lever, a_bl.shape))
                + np.cross(w_bl, np.cross(w_bl, np.broadcast_to(lever, a_bl.shape))))
        acc_c = a_bl @ self.sm.T - self.bias_accel_corr
        gyro_c = w_bl - self.bias_gyro_corr

        frames = {"time": [self.last_prop_time], "x": [oracle.state_copy(self.x)],
                  "w": [np.array(self.last_w)], "a": [np.array(self.last_a)]}
        x, P = self.x, self.P
        for i in range(n_imu):
            x, P = oracle.predict(x, P, acc_c[i], gyro_c[i], dt[i], self.Q)
            frames["time"].append(stamps[i])
            frames["x"].append(oracle.state_copy(x))
            frames["w"].append(gyro_c[i])
            frames["a"].append(acc_c[i])
        if n_imu > 0:
            self.last_prop_time = float(stamps[-1])
            self.last_w_raw_bl = w_bl[-1]
            self.last_w = gyro_c[-1]
            self.last_a = acc_c[-1]
        return x, P, frames

    def _preprocess(self, points, t_raw, n_pts, imu_stamp_now):
        cfg = self.cfg
        f = cfg.filters
        pts = points[:n_pts].astype(np.float64)
        traw = t_raw[:n_pts].astype(np.float64)
        valid = np.all(np.isfinite(pts), axis=-1)
        if f.crop_active:
            inside = np.all((pts >= np.asarray(f.cropBoxMin))
                            & (pts <= np.asarray(f.cropBoxMax)), axis=-1)
            valid &= ~inside
        if f.dist_active:
            valid &= np.linalg.norm(pts, axis=-1) > f.min_dist
        if f.rate_active:
            valid &= (np.arange(n_pts) % f.rate_value) == 0
        if f.fov_active:
            valid &= np.abs(np.arctan2(pts[:, 1], pts[:, 0])) < f.fov_angle

        st_, eos = cfg.sensor_type, cfg.end_of_sweep
        if st_ == 0:
            t_abs = -traw * 1e-9 if eos else traw * 1e-9
        elif st_ == 1:
            t_abs = -traw if eos else traw
        elif st_ == 2:
            t_abs = traw
        else:
            t_abs = traw * 1e-9
        # sweep reference time is 0 in the packed layout (epoch-relative)
        # (tpu.time_sort mirrors the engine: ordering only affects f32
        # association downstream — in this f64 oracle it is immaterial,
        # but mirroring keeps the which-point traces identical)
        if cfg.tpu.time_sort:
            t_key = np.where(valid, t_abs, np.inf)
            order = np.argsort(t_key, kind="stable")
            pts, t_abs, valid = pts[order], t_abs[order], valid[order]
        nv = int(valid.sum())
        last_t = (np.max(t_abs[valid]) if nv > 0 else 0.0) \
            if not cfg.tpu.time_sort else (t_abs[nv - 1] if nv > 0 else 0.0)
        if cfg.time_offset:
            offset = min(imu_stamp_now - last_t - 1e-4, 0.0)
        else:
            offset = 0.0
        return pts[valid], t_abs[valid] + offset, last_t + offset

    def _deskew(self, pts, t_pts, frames, x_t2):
        ftime = np.asarray(frames["time"])
        idx = np.clip(np.searchsorted(ftime, t_pts, side="right") - 1, 0, None)
        fx = frames["x"]
        get = lambda key: np.asarray([fx[i][key] for i in range(len(fx))])
        q0 = get("rot")[idx]
        dt = (t_pts - ftime[idx])[:, None]
        w_eff = (np.asarray(frames["w"]) - get("bg"))[idx]
        a_body = (np.asarray(frames["a"]) - get("ba"))[idx]
        a0 = qrot_b(q0, a_body) + get("grav")[idx]
        q_i = qmul_b(q0, exp_quat_b(w_eff * dt))
        p_i = get("pos")[idx] + get("vel")[idx] * dt + 0.5 * a0 * dt * dt

        q_ext, t_ext = x_t2["rot_LI"], x_t2["t_LI"]
        pb = qrot_b(np.broadcast_to(q_ext, q_i.shape), pts) + t_ext
        pw = qrot_b(q_i, pb) + p_i
        q_inv = oracle.qconj(x_t2["rot"])
        return qrot_b(np.broadcast_to(q_inv, pw.shape[:-1] + (4,)),
                      pw - x_t2["pos"])

    def _voxel_downsample(self, pts, leaf):
        """Centroids in packed-key-sorted order (ops/voxel.py semantics)."""
        if len(pts) == 0:
            return pts
        vc = np.floor(pts / leaf).astype(np.int64)
        key = (((vc[:, 0] & 0x3FF) << 20) | ((vc[:, 1] & 0x3FF) << 10)
               | (vc[:, 2] & 0x3FF))
        srt = np.argsort(key, kind="stable")
        key_s, pts_s = key[srt], pts[srt]
        new_seg = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        seg_id = np.cumsum(new_seg) - 1
        S = int(seg_id[-1]) + 1
        sums = np.zeros((S, 3))
        cnt = np.zeros(S)
        np.add.at(sums, seg_id, pts_s)
        np.add.at(cnt, seg_id, 1.0)
        return sums / cnt[:, None]

    def _h_model(self, pc):
        """Measurement closure over baselink points (measurement.py:h_rows)."""
        cfg = self.cfg
        mp_cfg = cfg.ikfom.mapping
        k = mp_cfg.NUM_MATCH_POINTS

        def h_model(x):
            Rm = oracle.qmat(x["rot"])
            glob = pc @ Rm.T + x["pos"]
            nbrs, sq, vld = self.map.knn(glob, k)
            n_abcd, good = fit_planes(
                nbrs, sq, vld, k=k, max_dist_plane=mp_cfg.MAX_DIST_PLANE,
                plane_threshold=mp_cfg.PLANE_THRESHOLD)
            keep = good & (np.cumsum(good) <= mp_cfg.MAX_NUM_MATCHES)
            n = n_abcd[:, :3]
            dist = np.sum(n * glob, axis=-1) + n_abcd[:, 3]
            C = n @ Rm                                        # rows of Rᵀn
            A = np.cross(pc, C)
            if cfg.ikfom.estimate_extrinsics:
                RLI = oracle.qmat(x["rot_LI"])
                p_lidar = (pc - x["t_LI"]) @ RLI
                B = np.cross(p_lidar, C @ RLI)
                H = np.concatenate([n, A, B, C], axis=1)
            else:
                H = np.concatenate([n, A, np.zeros_like(n), np.zeros_like(n)],
                                   axis=1)
            H = np.where(keep[:, None], H, 0.0)
            h = np.where(keep, -dist, 0.0)
            self.last_n_matches = int(keep.sum())
            return H, h

        return h_model

    # ---- the step ----------------------------------------------------
    def scan_step(self, scan_pack, imu_pack):
        cfg = self.cfg
        assert float(cfg.tpu.quantize_transfer) == 0.0, \
            "oracle replay expects unquantized packs"
        n_pts = int(imu_pack[0, 7])
        epoch_shift = float(imu_pack[2, 7])
        self.prev_scan_stamp -= epoch_shift
        self.last_prop_time -= epoch_shift

        x_t2, P_t2, frames = self._imu_chain(imu_pack)
        imu_stamp_now = self.last_prop_time

        pts, t_abs, scan_end = self._preprocess(
            scan_pack[:, :3], scan_pack[:, 3], n_pts, imu_stamp_now)
        p_xt2 = self._deskew(pts, t_abs, frames, x_t2)

        if cfg.filters.voxel_active:
            pc_ds = self._voxel_downsample(p_xt2, float(cfg.filters.leafSize[0]))
        else:
            pc_ds = p_xt2
        if cfg.tpu.insert_population == "full" and cfg.tpu.max_insert_points:
            pc_ds = pc_ds[:cfg.tpu.max_insert_points]
        pc2match = pc_ds[:cfg.ikfom.mapping.MAX_NUM_PC2MATCH]

        h_model = self._h_model(pc2match)
        x_u, P_u, n_iters = oracle.update_iterated(
            x_t2, P_t2, h_model, R=cfg.ikfom.lidar_noise,
            D=cfg.ikfom.degeneracy_thresh, max_iters=cfg.ikfom.MAX_NUM_ITERS,
            limit=np.asarray(cfg.ikfom.LIMITS))
        if len(pc2match) <= 1:        # NULL ITERATION guard
            x_u, P_u = x_t2, P_t2

        ins = pc_ds if cfg.tpu.insert_population == "full" else pc2match
        w_scan = ins @ oracle.qmat(x_u["rot"]).T + x_u["pos"]
        if len(pc2match) > 1:
            self.map.insert(w_scan)

        if not cfg.calibrate_gyro:
            self.bias_gyro_corr = np.array(x_u["bg"])
        if not cfg.calibrate_accel:
            self.bias_accel_corr = np.array(x_u["ba"])

        self.x, self.P = x_u, P_u
        self.prev_scan_stamp = scan_end
        return {"pos": np.array(x_u["pos"]), "quat": np.array(x_u["rot"]),
                "vel": np.array(x_u["vel"]), "n_pc2match": len(pc2match),
                "n_matches": self.last_n_matches,
                "map_points": self.map.num_points, "n_iters": n_iters,
                "scan_end": scan_end}
