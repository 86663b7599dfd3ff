"""Autodiff benchmark (reference internal/ceres/autodiff_benchmarks/):
linearization throughput per cost function — the reference's full set,
from a trivial constant cost to Disney-BRDF and photometric-patch costs.
This version measures the full vmapped jacfwd bucket evaluation
(residuals + Jacobians per second), since that is the unit of work the
evaluator issues.

Cost set (autodiff_benchmarks.cc): Constant, Linear1, Linear10, Rat43,
SnavelyReprojection, QuaternionRotatePoint (rotation-heavy core),
RelativePoseError (SE(3) pose-graph edge, relative_pose_error.h),
Brdf (Disney principled BRDF, brdf_cost_function.h — formulas from
Burley, "Physically-based shading at Disney", SIGGRAPH 2012),
PhotometricError (8-pixel patch, double-sphere camera + bicubic image
interpolation, photometric_error.h).

Usage: python -m benchmarks.autodiff_benchmark [--cpu]
"""

from __future__ import annotations

import sys

from .common import bench, block, setup_platform


def main(argv=None):
    jax = setup_platform()
    import jax.numpy as jnp
    import numpy as np
    from ceres_tpu import rotation as rot
    from ceres_tpu.interpolation import BiCubicInterpolator, Grid2D

    dname = jax.devices()[0].platform
    N = 100_000
    rng = np.random.default_rng(0)

    def unit(v, axis=-1):
        return v / np.linalg.norm(v, axis=axis, keepdims=True)

    # ---- simple costs ----
    def constant_cost(p):
        return jnp.ones((3,), dtype=p.dtype)

    def linear_cost(p):
        return p - 1.0

    def rat43(p, xy):
        x, y = xy[0], xy[1]
        return jnp.reshape(
            y - p[0] / (1.0 + jnp.exp(p[1] - p[2] * x)) ** (1.0 / p[3]),
            (1,))

    def snavely(cam, pt):
        p = rot.angle_axis_rotate_point(cam[:3], pt) + cam[3:6]
        xp, yp = -p[0] / p[2], -p[1] / p[2]
        r2 = xp * xp + yp * yp
        d = 1.0 + r2 * (cam[7] + cam[8] * r2)
        return jnp.stack([cam[6] * d * xp, cam[6] * d * yp])

    def quat_rotate(q, pt):
        return rot.unit_quaternion_rotate_point(q / jnp.linalg.norm(q), pt)

    # ---- relative pose error (SE(3) pose-graph edge) ----
    meas_q = jnp.asarray(unit(np.array([0.9, 0.1, -0.2, 0.05])))
    meas_t = jnp.asarray([0.3, -0.2, 0.1])

    def relative_pose(pose_i, pose_j):
        q_i = pose_i[:4] / jnp.linalg.norm(pose_i[:4])
        q_j = pose_j[:4] / jnp.linalg.norm(pose_j[:4])
        t_i, t_j = pose_i[4:], pose_j[4:]
        q_j_inv = rot.quaternion_conjugate(q_j)
        est_q = rot.quaternion_product(q_j_inv, q_i)
        est_t = rot.unit_quaternion_rotate_point(q_j_inv, t_i - t_j)
        res_q = rot.quaternion_product(meas_q, est_q)
        res_t = rot.unit_quaternion_rotate_point(meas_q, est_t) + meas_t
        return jnp.concatenate([rot.quaternion_to_angle_axis(res_q),
                                res_t])

    # ---- Disney principled BRDF (Burley SIGGRAPH 2012) ----
    def _lerp(a, b, t):
        return a + t * (b - a)

    def _schlick(u):
        m = jnp.clip(1.0 - u, 0.0, 1.0)
        return (m * m) * (m * m) * m

    def _gtr1(ndh, a):
        a2 = a * a
        t = 1.0 + (a2 - 1.0) * ndh * ndh
        return (a2 - 1.0) / (jnp.pi * jnp.log(a2) * t)

    def _gtr2_aniso(ndh, hdx, hdy, ax, ay):
        t = (hdx / ax) ** 2 + (hdy / ay) ** 2 + ndh * ndh
        return 1.0 / (jnp.pi * ax * ay * t * t)

    def _smith_ggx(ndv, ag):
        a = ag * ag
        b = ndv * ndv
        return 1.0 / (ndv + jnp.sqrt(a + b - a * b))

    def brdf(material, c, n, v, l, x, y):
        (metallic, subsurface, specular, roughness, specular_tint,
         anisotropic, sheen, sheen_tint, clearcoat,
         clearcoat_gloss) = material

        n_dot_l = jnp.dot(n, l)
        n_dot_v = jnp.dot(n, v)
        h = (l + v) / jnp.linalg.norm(l + v)
        n_dot_h = jnp.dot(n, h)
        l_dot_h = jnp.dot(l, h)
        h_dot_x = jnp.dot(h, x)
        h_dot_y = jnp.dot(h, y)

        c_lum = 0.3 * c[0] + 0.6 * c[1] + 0.1 * c[2]
        c_tint = c / c_lum
        ones = jnp.ones(3, dtype=c.dtype)
        c_spec0 = _lerp(specular * 0.08 * _lerp(ones, c_tint,
                                                specular_tint),
                        c, metallic)
        c_sheen = _lerp(ones, c_tint, sheen_tint)

        # diffuse fresnel with retro-reflection
        fl, fv = _schlick(n_dot_l), _schlick(n_dot_v)
        fd_90 = 0.5 + 2.0 * l_dot_h * l_dot_h * roughness
        fd = _lerp(1.0, fd_90, fl) * _lerp(1.0, fd_90, fv)

        # Hanrahan-Krueger subsurface approximation
        fss_90 = l_dot_h * l_dot_h * roughness
        fss = _lerp(1.0, fss_90, fl) * _lerp(1.0, fss_90, fv)
        ss = 1.25 * (fss * (1.0 / (n_dot_l + n_dot_v) - 0.5) + 0.5)

        # anisotropic specular
        aspect = jnp.sqrt(1.0 - 0.9 * anisotropic)
        ax = jnp.maximum(roughness ** 2 / aspect, 1e-3)
        ay = jnp.maximum(roughness ** 2 * aspect, 1e-3)
        ds = _gtr2_aniso(n_dot_h, h_dot_x, h_dot_y, ax, ay)
        fh = _schlick(l_dot_h)
        fs = _lerp(c_spec0, ones, fh)
        roughg = (roughness * 0.5 + 0.5) ** 2
        gs = _smith_ggx(n_dot_l, roughg) * _smith_ggx(n_dot_v, roughg)

        f_sheen = fh * sheen * c_sheen

        # clearcoat lobe (F0 = 0.04)
        a_cc = _lerp(0.1, 1e-3, clearcoat_gloss)
        dr = _gtr1(n_dot_h, a_cc)
        fr = _lerp(0.04, 1.0, fh)
        gr = _smith_ggx(n_dot_l, 0.25) * _smith_ggx(n_dot_v, 0.25)

        out = ((1.0 / jnp.pi) * _lerp(fd, ss, subsurface) * c
               + f_sheen) * (1.0 - metallic) \
            + gs * fs * ds + 0.25 * clearcoat * gr * fr * dr
        return n_dot_l * out

    # ---- photometric patch error (double-sphere camera + bicubic) ----
    PATCH = 8
    img = np.sin(np.arange(64)[:, None] * 0.3) \
        + np.cos(np.arange(64)[None, :] * 0.2) + 2.0
    interp = BiCubicInterpolator(Grid2D(jnp.asarray(img)))
    fx, fy, cx, cy, alpha, beta = 50.0, 50.0, 32.0, 32.0, 0.4, 1.1
    bearings = jnp.asarray(unit(np.concatenate(
        [rng.uniform(-0.2, 0.2, (2, PATCH)),
         np.ones((1, PATCH))], axis=0), axis=0))        # [3, PATCH], +z
    intens_host = jnp.asarray(rng.uniform(1.0, 3.0, PATCH))

    def photometric(pose_h, pose_t, idist):
        q_h = pose_h[:4] / jnp.linalg.norm(pose_h[:4])
        q_t = pose_t[:4] / jnp.linalg.norm(pose_t[:4])
        t_h, t_t = pose_h[4:], pose_t[4:]
        q_th = rot.quaternion_product(rot.quaternion_conjugate(q_t), q_h)
        R = rot.quaternion_to_rotation_matrix(q_th)
        t_th = rot.unit_quaternion_rotate_point(
            rot.quaternion_conjugate(q_t), t_h - t_t)
        p = R @ bearings + idist[0] * t_th[:, None]      # [3, PATCH]
        rho = jnp.sqrt(beta * (p[0] ** 2 + p[1] ** 2) + p[2] ** 2)
        norm = alpha * rho + (1.0 - alpha) * p[2]
        u = fx * p[0] / norm + cx
        v = fy * p[1] / norm + cy
        return interp.evaluate(v, u) - intens_host

    # ---- per-case input generators (some costs need valid domains) ----
    def normal_args(*shapes):
        return [jnp.asarray(rng.normal(size=(N,) + s) + 1.0)
                for s in shapes]

    def pose_args(k):
        out = []
        for _ in range(k):
            q = unit(np.array([1.0, 0, 0, 0])
                     + 0.1 * rng.normal(size=(N, 4)))
            t = 0.3 * rng.normal(size=(N, 3))
            out.append(jnp.asarray(np.concatenate([q, t], axis=1)))
        return out

    def brdf_args():
        mat = jnp.asarray(rng.uniform(0.1, 0.9, (N, 10)))
        c = jnp.asarray(rng.uniform(0.2, 1.0, (N, 3)))
        # orthonormal-ish shading frame with v, l in the upper hemisphere
        n = unit(rng.normal(size=(N, 3)))
        v = unit(n + 0.5 * rng.normal(size=(N, 3)))
        l = unit(n + 0.5 * rng.normal(size=(N, 3)))
        flip_v = np.sign(np.sum(n * v, axis=1, keepdims=True))
        flip_l = np.sign(np.sum(n * l, axis=1, keepdims=True))
        v, l = v * flip_v, l * flip_l
        x = unit(np.cross(n, v + np.array([0.11, 0.17, 0.23])))
        y = unit(np.cross(n, x))
        return [jnp.asarray(a) for a in (mat, c, n, v, l, x, y)]

    def photometric_args():
        ph, pt = pose_args(2)
        idist = jnp.asarray(rng.uniform(0.3, 0.7, (N, 1)))
        return [ph, pt, idist]

    cases = [
        ("Constant3", constant_cost, normal_args((3,))),
        ("Linear1", linear_cost, normal_args((1,))),
        ("Linear10", linear_cost, normal_args((10,))),
        ("Rat43", rat43, [
            # NIST Rat43 domain: positive growth-curve parameters
            jnp.asarray(np.array([700.0, 5.0, 0.75, 1.3])
                        * rng.uniform(0.8, 1.2, (N, 4))),
            jnp.asarray(np.stack([rng.uniform(1.0, 15.0, N),
                                  rng.uniform(0.0, 700.0, N)], axis=1)),
        ]),
        ("SnavelyReprojection", snavely, normal_args((9,), (3,))),
        ("QuaternionRotatePoint", quat_rotate, normal_args((4,), (3,))),
        ("RelativePoseError", relative_pose, pose_args(2)),
        ("Brdf", brdf, brdf_args()),
        ("PhotometricError8", photometric, photometric_args()),
    ]

    for name, fn, args in cases:
        def one(*ps, _fn=fn):
            def g(*qs):
                r = jnp.atleast_1d(_fn(*qs))
                return r, r
            J, r = jax.jacfwd(g, argnums=tuple(range(len(ps))),
                              has_aux=True)(*ps)
            return r, J

        f = jax.jit(jax.vmap(one))
        out = block(f(*args))
        assert all(bool(jnp.all(jnp.isfinite(x)))
                   for x in jax.tree_util.tree_leaves(out)), name
        bench(f"AutoDiff_{name}", lambda: block(f(*args)),
              device=dname, n=N)
    return 0


if __name__ == "__main__":
    sys.exit(main())
