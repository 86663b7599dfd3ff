"""BAL (Bundle Adjustment in the Large) problem loader + synthetic generator.

Capability parity with the reference's examples/bal_problem.{h,cc}:
file loading, Normalize (:59, median-recentering + scale), Perturb (:67,
noise injection with fixed RNG), CameraToAngleAxisAndCenter, and the
use_quaternions repacking option. The synthetic generator replaces the
BAL dataset download for tests/benchmarks (the reference repo also ships no
BAL file; fake_bundle_adjustment_jacobian.h:42 plays the same role for its
benchmarks): cameras on a ring looking at a Gaussian point cloud, with
observation structure (ncam/npts/nobs) matching a requested real problem.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def _np_angle_axis_rotate(aa, pts):
    """Pure-numpy Rodrigues rotation (generator/normalize stay off-device:
    eager jnp ops dispatch one device program each)."""
    theta = np.linalg.norm(aa, axis=-1, keepdims=True)
    small = theta[..., 0] < 1e-12
    safe = np.where(theta == 0, 1.0, theta)
    w = aa / safe
    c = np.cos(theta)
    s = np.sin(theta)
    w_cross_p = np.cross(w, pts)
    w_dot_p = np.sum(w * pts, axis=-1, keepdims=True)
    out = pts * c + w_cross_p * s + w * w_dot_p * (1.0 - c)
    return np.where(small[..., None], pts + np.cross(aa, pts), out)


def _np_angle_axis_to_quaternion(aa):
    theta_sq = np.sum(aa * aa, axis=-1, keepdims=True)
    small = theta_sq[..., 0] < 1e-12
    theta = np.sqrt(np.where(small[..., None], 1.0, theta_sq))
    k = np.where(small[..., None], 0.5 - theta_sq / 48.0,
                 np.sin(0.5 * theta) / theta)
    w = np.where(small[..., None], 1.0 - theta_sq / 8.0,
                 np.cos(0.5 * theta))
    return np.concatenate([w, aa * k], axis=-1)


def _np_quaternion_to_angle_axis(q):
    """Inverse of _np_angle_axis_to_quaternion (w-first)."""
    w = q[..., :1]
    v = q[..., 1:]
    sn_sq = np.sum(v * v, axis=-1, keepdims=True)
    small = sn_sq[..., 0] < 1e-24
    sn = np.sqrt(np.where(small[..., None], 1.0, sn_sq))
    theta = 2.0 * np.arctan2(sn, w)
    k = np.where(small[..., None], 2.0 / np.where(w == 0, 1.0, w),
                 theta / sn)
    return v * k


class BALProblem:
    """cameras: [ncam, 9] (angle-axis 3, t 3, f, k1, k2) or [ncam, 10]
    (quaternion w-first 4, t 3, f, k1, k2) when use_quaternions.
    points: [npts, 3]; observations: [nobs, 2]; camera_index/point_index:
    [nobs] int."""

    def __init__(self, cameras, points, camera_index, point_index,
                 observations, use_quaternions=False):
        self.cameras = np.ascontiguousarray(cameras, dtype=np.float64)
        self.points = np.ascontiguousarray(points, dtype=np.float64)
        self.camera_index = np.asarray(camera_index, dtype=np.int64)
        self.point_index = np.asarray(point_index, dtype=np.int64)
        self.observations = np.ascontiguousarray(observations,
                                                 dtype=np.float64)
        self.use_quaternions = use_quaternions

    @property
    def num_cameras(self):
        return self.cameras.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    @property
    def num_observations(self):
        return self.observations.shape[0]

    @classmethod
    def from_file(cls, path: str, use_quaternions: bool = False
                  ) -> "BALProblem":
        """Parse the BAL text format (bal_problem.cc:88-132)."""
        with open(path) as f:
            tokens = f.read().split()
        ncam, npts, nobs = (int(tokens[0]), int(tokens[1]),
                            int(tokens[2]))
        # vectorized parse: token-by-token Python loops cost tens of
        # seconds on the big BAL sets (venice: ~25M tokens)
        body = np.asarray(tokens[3:3 + 4 * nobs + 9 * ncam + 3 * npts],
                          dtype=np.float64)
        head = body[:4 * nobs].reshape(nobs, 4)
        cam_idx = head[:, 0].astype(np.int64)
        pt_idx = head[:, 1].astype(np.int64)
        obs = head[:, 2:4].copy()
        o = 4 * nobs
        cams = body[o:o + 9 * ncam].reshape(ncam, 9).copy()
        o += 9 * ncam
        pts = body[o:o + 3 * npts].reshape(npts, 3).copy()
        problem = cls(cams, pts, cam_idx, pt_idx, obs)
        if use_quaternions:
            problem = problem.to_quaternions()
        return problem

    def to_quaternions(self) -> "BALProblem":
        q = _np_angle_axis_to_quaternion(self.cameras[:, :3])
        cams = np.concatenate([q, self.cameras[:, 3:]], axis=1)
        return BALProblem(cams, self.points, self.camera_index,
                          self.point_index, self.observations,
                          use_quaternions=True)

    # ---- bal_problem.cc Normalize (:59) ----
    def normalize(self):
        """Recenter at the point-cloud median, rescale so the median
        absolute deviation is 100 (bal_problem.cc Normalize)."""
        median = np.median(self.points, axis=0)
        dev = np.sum(np.abs(self.points - median), axis=1)
        scale = 100.0 / np.median(dev) if np.median(dev) > 0 else 1.0
        self.points = scale * (self.points - median)
        # camera center c = -R' t; t = -R (c - median) * scale
        if self.use_quaternions:
            aa = _np_quaternion_to_angle_axis(self.cameras[:, :4])
            t = self.cameras[:, 4:7]
            centers = _np_angle_axis_rotate(-aa, -t)
            new_centers = scale * (centers - median)
            self.cameras[:, 4:7] = _np_angle_axis_rotate(aa, -new_centers)
            return
        aa = self.cameras[:, :3]
        t = self.cameras[:, 3:6]
        centers = _np_angle_axis_rotate(-aa, -t)
        new_centers = scale * (centers - median)
        self.cameras[:, 3:6] = _np_angle_axis_rotate(aa, -new_centers)

    # ---- bal_problem.cc Perturb (:67) ----
    def perturb(self, rotation_sigma=0.0, translation_sigma=0.0,
                point_sigma=0.0, seed=38401):
        rng = np.random.default_rng(seed)
        if point_sigma > 0:
            self.points += rng.normal(0, point_sigma, self.points.shape)
        if self.use_quaternions:
            # layout [q4 | t3 | f,k1,k2]: translation lives at 4:7 and
            # rotation noise applies in angle-axis, re-packed to a unit
            # quaternion (bal_problem.cc Perturb via
            # CameraToAngleAxisAndCenter)
            if translation_sigma > 0:
                self.cameras[:, 4:7] += rng.normal(
                    0, translation_sigma, (self.num_cameras, 3))
            if rotation_sigma > 0:
                aa = _np_quaternion_to_angle_axis(self.cameras[:, :4])
                aa += rng.normal(0, rotation_sigma,
                                 (self.num_cameras, 3))
                self.cameras[:, :4] = _np_angle_axis_to_quaternion(aa)
            return
        if translation_sigma > 0:
            self.cameras[:, 3:6] += rng.normal(
                0, translation_sigma, (self.num_cameras, 3))
        if rotation_sigma > 0:
            self.cameras[:, :3] += rng.normal(
                0, rotation_sigma, (self.num_cameras, 3))


def synthetic_bal_problem(num_cameras: int, num_points: int,
                          num_observations: int, seed: int = 0,
                          pixel_noise: float = 1.0) -> BALProblem:
    """Generate a BAL-structured problem: cameras on a ring of radius ~3
    looking inward at a unit-ish Gaussian cloud; every point observed by a
    contiguous run of cameras (realistic covisibility); observations =
    true projection + pixel noise, cameras/points later perturbed by the
    caller to make the optimization non-trivial."""
    rng = np.random.default_rng(seed)
    points = rng.normal(0.0, 1.0, (num_points, 3))

    def _rotmat_to_angle_axis(R):
        # Local numpy R->quaternion->angle-axis (kept separate from
        # rotation.py's traced version so the synthetic problem instances
        # stay byte-identical across releases — benchmark continuity).
        t = np.trace(R)
        if t > 0:
            w = 0.5 * np.sqrt(1.0 + t)
            v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                          R[1, 0] - R[0, 1]]) / (4.0 * w)
        else:
            i = int(np.argmax(np.diag(R)))
            j, k = (i + 1) % 3, (i + 2) % 3
            sq = np.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12))
            v = np.zeros(3)
            v[i] = 0.5 * sq
            w = (R[k, j] - R[j, k]) / (2.0 * sq)
            v[j] = (R[j, i] + R[i, j]) / (2.0 * sq)
            v[k] = (R[k, i] + R[i, k]) / (2.0 * sq)
        n = np.linalg.norm(v)
        if n < 1e-12:
            return np.zeros(3)
        angle = 2.0 * np.arctan2(n, w)
        return angle * v / n

    # Cameras on a ring of radius 8 around the unit cloud, each looking at
    # the origin (BAL convention: p = R X + t, camera looks along -z, so R
    # maps the camera-center direction to +z). Depth to every point stays
    # in ~[3.5, 12.5], far from the projection singularity even after the
    # caller's perturbation.
    radius = 8.0
    cameras = np.zeros((num_cameras, 9))
    for i in range(num_cameras):
        theta = 2.0 * math.pi * i / max(num_cameras, 1)
        center = np.array([radius * math.cos(theta),
                           1.5 * math.sin(2.0 * theta),
                           radius * math.sin(theta)])
        z_cam = center / np.linalg.norm(center)
        up = np.array([0.0, 1.0, 0.0])
        x_cam = np.cross(up, z_cam)
        x_cam /= np.linalg.norm(x_cam)
        y_cam = np.cross(z_cam, x_cam)
        R = np.stack([x_cam, y_cam, z_cam])   # rows: world -> camera
        cameras[i, :3] = _rotmat_to_angle_axis(R)
        cameras[i, 3:6] = -R @ center
        cameras[i, 6] = 500.0 + 20.0 * rng.normal()
        cameras[i, 7] = 1e-7 * rng.normal()
        cameras[i, 8] = 1e-13 * rng.normal()

    # observation structure: contiguous camera windows per point, remainder
    # spread over the first points so the total matches exactly
    if num_observations > num_points * num_cameras:
        raise ValueError(
            f"num_observations={num_observations} exceeds the "
            f"num_points*num_cameras={num_points * num_cameras} distinct "
            f"(point, camera) pairs")
    base = max(1, num_observations // num_points)
    rem = max(0, num_observations - base * num_points)
    cam_idx = []
    pt_idx = []
    starts = np.zeros(num_points, dtype=np.int64)
    counts = np.zeros(num_points, dtype=np.int64)
    for p in range(num_points):
        start = rng.integers(0, num_cameras)
        starts[p] = start
        k = min(base + (1 if p < rem else 0), num_cameras)
        counts[p] = k
        for j in range(k):
            cam_idx.append((start + j) % num_cameras)
            pt_idx.append(p)
    # per-point windows clamp at num_cameras; top up by widening other
    # points' windows so the requested total is met EXACTLY (no RNG use:
    # unclamped shapes — every existing benchmark — stay byte-identical)
    deficit = num_observations - len(cam_idx)
    p = 0
    while deficit > 0:
        if counts[p] < num_cameras:
            cam_idx.append(int((starts[p] + counts[p]) % num_cameras))
            pt_idx.append(p)
            counts[p] += 1
            deficit -= 1
        else:
            p += 1
    cam_idx = np.asarray(cam_idx[:num_observations], dtype=np.int64)
    pt_idx = np.asarray(pt_idx[:num_observations], dtype=np.int64)

    # project (pure numpy)
    cams_o = cameras[cam_idx]
    pts_o = points[pt_idx]
    p = _np_angle_axis_rotate(cams_o[:, :3], pts_o) + cams_o[:, 3:6]
    xp = -p[:, 0] / p[:, 2]
    yp = -p[:, 1] / p[:, 2]
    r2 = xp * xp + yp * yp
    distortion = 1.0 + r2 * (cams_o[:, 7] + cams_o[:, 8] * r2)
    obs = np.stack([cams_o[:, 6] * distortion * xp,
                    cams_o[:, 6] * distortion * yp], axis=1)
    obs += pixel_noise * rng.normal(size=obs.shape)
    return BALProblem(cameras, points, cam_idx, pt_idx, obs)


def build_bal_ceres_problem(bal: BALProblem, loss=None,
                            use_quaternions: bool = False,
                            use_manifolds: bool = True):
    """Build a ceres_tpu Problem from a BALProblem (the
    simple_bundle_adjuster.cc / bundle_adjuster.cc model-build path).
    Returns (problem, camera_arrays, point_arrays).

    use_manifolds=False with quaternions treats the quaternion as a plain
    Euclidean 4-block (bundle_adjuster.cc --use_manifolds=false)."""
    import ceres_tpu as ct
    from ..examples.snavely import (SnavelyReprojectionError,
                                    SnavelyReprojectionErrorWithQuaternions)

    if use_quaternions and not bal.use_quaternions:
        bal = bal.to_quaternions()

    cam_arrays = [bal.cameras[i].copy() for i in range(bal.num_cameras)]
    pt_arrays = [bal.points[i].copy() for i in range(bal.num_points)]

    problem = ct.Problem()
    cam_size = 10 if bal.use_quaternions else 9
    for i in range(bal.num_observations):
        ox, oy = bal.observations[i]
        if bal.use_quaternions:
            cost = ct.AutoDiffCostFunction(
                SnavelyReprojectionErrorWithQuaternions(ox, oy), 2,
                [cam_size, 3])
        else:
            cost = ct.AutoDiffCostFunction(
                SnavelyReprojectionError(ox, oy), 2, [cam_size, 3])
        problem.add_residual_block(cost, loss,
                                   cam_arrays[bal.camera_index[i]],
                                   pt_arrays[bal.point_index[i]])
    if bal.use_quaternions and use_manifolds:
        man = ct.ProductManifold(ct.QuaternionManifold(),
                                 ct.EuclideanManifold(6))
        for c in cam_arrays:
            problem.set_manifold(c, man)
    return problem, cam_arrays, pt_arrays
