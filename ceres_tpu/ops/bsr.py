"""Bucketed block-sparse Jacobian: the device-native BlockSparseMatrix.

Replaces the reference's L1 matrix kernels (block_sparse_matrix.{h,cc},
block_structure.h, small_blas.h, partitioned_matrix_view) with a layout
designed for batched dense contractions: residual blocks are grouped into shape-uniform
*buckets*; a bucket's Jacobian is one dense tensor [n_blocks, r, t_total]
(r = residual size, t_total = sum of the tangent sizes of the parameter
slots). SpMV, J^T v, squared column norms, and J^T J block-diagonals are
batched einsums + scatter-adds — shapes XLA compiles to dense batched
kernels, with no scalar block loops (contrast small_blas.h's
hand-unrolled small GEMMs).

Column indexing: slot s of bucket k stores an int32 gather map
cols[s] : [n, t_s] of global tangent-space column indices.

Residual vectors are carried as per-bucket [n, r] arrays (class RVec); rows
of bucket k occupy [row_offset, row_offset + n*r) of the logical flat
residual vector.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.tree_util import register_pytree_node_class


@register_pytree_node_class
class BucketJacobian:
    """Jacobian of one bucket of residual blocks.

    J:    [n, r, t_total] block Jacobians (tangent space, loss-corrected).
    cols: tuple over variable slots of [n, t_s] int32 global column indices.
    onehots: optional tuple over slots of [n, k_s] f32 block one-hots (or
        None per slot) — when present, transpose-side accumulations run as
        one-hot matmuls instead of duplicate-heavy scatters.
    gcols: tuple over slots of [k_s, t_s] int32 group tangent columns
        (aligned with onehots; None when the slot has no one-hot).
    """

    def __init__(self, J, cols: Tuple, row_offset: int,
                 onehots: Tuple = None, gcols: Tuple = None,
                 sorted_slot: int = -1, tlocals: Tuple = None,
                 tslabs: Tuple = None):
        self.J = J
        self.cols = tuple(cols)
        self.row_offset = int(row_offset)
        self.onehots = (tuple(onehots) if onehots is not None
                        else (None,) * len(self.cols))
        self.gcols = (tuple(gcols) if gcols is not None
                      else (None,) * len(self.cols))
        # index of the variable slot whose block ids are sorted across the
        # bucket rows (-1 = none): its scatters use indices_are_sorted.
        self.sorted_slot = int(sorted_slot)
        # Tangent slab row-take structure: tlocals[s] = [n] block row ids
        # within the slot's size group; tslabs[s] = (start, k, t) of the
        # group's contiguous slab in tangent space (None -> flat gather).
        self.tlocals = (tuple(tlocals) if tlocals is not None
                        else (None,) * len(self.cols))
        self.tslabs = (tuple(tslabs) if tslabs is not None
                       else (None,) * len(self.cols))

    @property
    def n(self):
        return self.J.shape[0]

    @property
    def r(self):
        return self.J.shape[1]

    @property
    def t_total(self):
        return self.J.shape[2]

    @property
    def all_cols(self):
        """[n, t_total] concatenated column indices."""
        if not self.cols:   # all-constant bucket: zero tangent columns
            return jnp.zeros((self.n, 0), dtype=jnp.int32)
        return jnp.concatenate(self.cols, axis=1) if len(self.cols) > 1 \
            else self.cols[0]

    def slot_J(self, s: int):
        """[n, r, t_s] slice of J for variable slot s."""
        off = 0
        for i in range(s):
            off += self.cols[i].shape[1]
        return self.J[:, :, off:off + self.cols[s].shape[1]]

    def tree_flatten(self):
        return (self.J, self.cols, self.onehots, self.gcols,
                self.tlocals), (self.row_offset, self.sorted_slot,
                                self.tslabs)

    @classmethod
    def tree_unflatten(cls, aux, children):
        J, cols, onehots, gcols, tlocals = children
        return cls(J, cols, aux[0], onehots, gcols, aux[1], tlocals,
                   aux[2])

    def gather_cols(self, v):
        """v[all_cols] as [n, t_total] via slab row-takes when available."""
        parts = []
        for s, c in enumerate(self.cols):
            sl = self.tslabs[s]
            if sl is not None and self.tlocals[s] is not None:
                start, k, t = sl
                Vg = v[start:start + k * t].reshape(k, t)
                parts.append(Vg[self.tlocals[s]])
            else:
                parts.append(v[c])
        if not parts:   # all-constant bucket
            return jnp.zeros((self.n, 0), dtype=v.dtype)
        return parts[0] if len(parts) == 1 else jnp.concatenate(parts,
                                                                axis=1)

    def slot_off(self, s: int) -> int:
        off = 0
        for i in range(s):
            off += self.cols[i].shape[1]
        return off


@register_pytree_node_class
class RVec:
    """Per-bucket residual-space vector (logical length num_rows)."""

    def __init__(self, parts: Sequence):
        self.parts = tuple(parts)  # each [n_k, r_k]

    def tree_flatten(self):
        return (self.parts,), ()

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0])

    def dot(self, other: "RVec"):
        return sum(jnp.vdot(a, b) for a, b in zip(self.parts, other.parts))

    def squared_norm(self):
        return sum(jnp.sum(p * p) for p in self.parts)

    def norm(self):
        return jnp.sqrt(self.squared_norm())

    def __add__(self, other):
        return RVec([a + b for a, b in zip(self.parts, other.parts)])

    def __sub__(self, other):
        return RVec([a - b for a, b in zip(self.parts, other.parts)])

    def __neg__(self):
        return RVec([-a for a in self.parts])

    def scale(self, c):
        return RVec([c * a for a in self.parts])

    def flatten(self):
        return jnp.concatenate([p.reshape(-1) for p in self.parts]) \
            if self.parts else jnp.zeros((0,))


@register_pytree_node_class
class BlockJacobian:
    """The full Jacobian as a tuple of BucketJacobians.

    Capability parity with the reference's SparseMatrix interface
    (sparse_matrix.h: RightMultiplyAndAccumulate / LeftMultiplyAndAccumulate /
    SquaredColumnNorm / ScaleColumns / ToDenseMatrix).
    """

    def __init__(self, buckets: Sequence[BucketJacobian], num_rows: int,
                 num_cols: int):
        self.buckets = tuple(buckets)
        self.num_rows = int(num_rows)
        self.num_cols = int(num_cols)

    def tree_flatten(self):
        return (self.buckets,), (self.num_rows, self.num_cols)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(children[0], *aux)

    # --- SparseMatrix interface ---

    def matvec(self, v) -> RVec:
        """J v: tangent [num_cols] -> residual space."""
        parts = []
        for b in self.buckets:
            vb = b.gather_cols(v)                   # [n, t_total]
            parts.append(jnp.einsum("nrt,nt->nr", b.J, vb))
        return RVec(parts)

    def _scatter_by_slot(self, b: BucketJacobian, contrib, out):
        """out[cols] += contrib, slot by slot: one-hot matmul where the
        slot has few distinct blocks, scatter-add otherwise."""
        off = 0
        for s, c in enumerate(b.cols):
            t_s = c.shape[1]
            part = contrib[:, off:off + t_s]
            oh, gc = b.onehots[s], b.gcols[s]
            if oh is not None:
                acc = jnp.einsum("nk,nt->kt", oh.astype(part.dtype), part)
                out = out.at[gc].add(acc)
            else:
                # NOTE: even with rows sorted by block id, the flattened
                # [n, t] indices are not monotonic (within-block columns
                # repeat), so indices_are_sorted must NOT be passed.
                out = out.at[c].add(part)
            off += t_s
        return out

    def rmatvec(self, w: RVec):
        """J^T w: residual space -> tangent [num_cols]."""
        out = jnp.zeros((self.num_cols,), dtype=self.buckets[0].J.dtype)
        for b, wp in zip(self.buckets, w.parts):
            contrib = jnp.einsum("nrt,nr->nt", b.J, wp)  # [n, t_total]
            out = self._scatter_by_slot(b, contrib, out)
        return out

    def squared_column_norms(self):
        """diag(J^T J) (block_sparse_matrix.h SquaredColumnNorm)."""
        out = jnp.zeros((self.num_cols,), dtype=self.buckets[0].J.dtype)
        for b in self.buckets:
            out = self._scatter_by_slot(b, jnp.sum(b.J * b.J, axis=1), out)
        return out

    def scale_columns(self, scale) -> "BlockJacobian":
        """J <- J diag(scale) (block_sparse_matrix ScaleColumns)."""
        buckets = []
        for b in self.buckets:
            sb = b.gather_cols(scale)  # [n, t_total]
            buckets.append(BucketJacobian(b.J * sb[:, None, :], b.cols,
                                          b.row_offset, b.onehots,
                                          b.gcols, b.sorted_slot,
                                          b.tlocals, b.tslabs))
        return BlockJacobian(buckets, self.num_rows, self.num_cols)

    def to_dense(self):
        """[num_rows, num_cols] dense matrix (ToDenseMatrix)."""
        dtype = self.buckets[0].J.dtype if self.buckets else jnp.float64
        A = jnp.zeros((self.num_rows, self.num_cols), dtype=dtype)
        for b in self.buckets:
            n, r, t = b.J.shape
            rows = (b.row_offset
                    + jnp.arange(n * r).reshape(n, r))     # [n, r]
            rows = jnp.broadcast_to(rows[:, :, None], (n, r, t))
            colm = jnp.broadcast_to(b.all_cols[:, None, :], (n, r, t))
            A = A.at[rows, colm].add(b.J)
        return A

    def jtj_dense(self):
        """Dense J^T J [num_cols, num_cols] without materializing J:
        per-bucket Gram blocks scattered into the normal matrix
        (replaces InnerProductComputer, inner_product_computer.h:93)."""
        H = jnp.zeros((self.num_cols, self.num_cols),
                      dtype=self.buckets[0].J.dtype)
        for b in self.buckets:
            G = jnp.einsum("nrt,nru->ntu", b.J, b.J)   # [n, t_total, t_total]
            c = b.all_cols
            n, t = c.shape
            rows = jnp.broadcast_to(c[:, :, None], (n, t, t))
            colm = jnp.broadcast_to(c[:, None, :], (n, t, t))
            H = H.at[rows, colm].add(G)
        return H


def block_diag_jtj(jac: BlockJacobian, groups):
    """Block diagonal of J^T J per parameter block, batched by tangent size.

    `groups` is static metadata built by the program (see program.py):
      groups: list of GroupMeta with
        .tangent_size t
        .num_blocks   k
        .bucket_slots list of (bucket_idx, slot_idx, local_ids [n] int32)
    Returns: list of [k, t, t] arrays, one per group.

    Replaces the reference's BlockSparseJacobiPreconditioner construction
    (block_jacobi_preconditioner.h:55): segment-summed batched outer products
    instead of per-cell mutex writes.
    """
    out = []
    for g in groups:
        acc = jnp.zeros((g.num_blocks, g.tangent_size, g.tangent_size),
                        dtype=jac.buckets[0].J.dtype)
        for (bi, si, local_ids) in g.bucket_slots:
            b = jac.buckets[bi]
            Js = b.slot_J(si)                         # [n, r, t]
            G = jnp.einsum("nrt,nru->ntu", Js, Js)    # [n, t, t]
            oh = b.onehots[si]
            if oh is not None:
                acc = acc + jnp.einsum("nk,ntu->ktu",
                                       oh.astype(G.dtype), G)
            else:
                acc = acc.at[local_ids].add(G)
        out.append(acc)
    return out
