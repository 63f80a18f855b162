"""Schur-complement reduction of submap blocks for the pose-graph solver.

The scale-out factorization of the distributed LM backend (BASELINE.json
north star; SURVEY §7 step 7): nodes are partitioned into S contiguous
submaps; every node touched by a cross-submap edge is promoted into a
global *separator* set. After permutation the normal equations take the
arrow form

    [ A   B ] [δ_int]   [−b_int]       A = blockdiag(A_1..A_S)
    [ Bᵀ  C ] [δ_sep] = [−b_sep]

so the solve factors into S *independent* dense Cholesky factorizations of
the submap systems A_k (batched over the mesh's submap axis — each is
(3m, 3m)), one psum to reduce the small separator system
S_c = C − Σ_k B_kᵀ A_k⁻¹ B_k, a replicated solve of S_c, and a batched
back-substitution. Complexity drops from (3M)³ to S·(3m)³ + (3·n_sep)³
and the only communication is the psum of the (3·n_sep)² separator system
— the batched replacement for the reference's serial sparse Cholesky
(CSparse/CHOLMOD, csparse.cpp; setupSparseSys spa2d.cpp:328-413), whose
fill-reducing orderings have no batched analogue.

Exactness: this is a permutation + block factorization of the SAME damped
gauge-fixed system as `pose_graph.dense_solve` (diag·(1+λ), fixed nodes →
identity rows/cols), so deltas agree to factorization roundoff.

Host/device split follows the framework rule: the data-dependent partition
(which nodes are separators, edge classification) is numpy on host; the
device program is fixed-shape over padded (S, m) internal slots.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from tpu_slam.solver.pose_graph import normal_equations


@dataclasses.dataclass(frozen=True)
class SchurPartition:
    """Host-built index maps of one graph partition (all numpy)."""

    n_submaps: int
    n_nodes: int
    int_nodes: np.ndarray  # (S, m) global node id per internal slot (pad 0)
    int_valid: np.ndarray  # (S, m) bool — slot holds a real node
    sep_nodes: np.ndarray  # (ns,) global node ids (pad 0)
    sep_valid: np.ndarray  # (ns,) bool
    # int-int edges, per submap (both endpoints internal to the submap)
    ii_edge: np.ndarray  # (S, Eii) edge index (pad 0)
    ii_li: np.ndarray  # (S, Eii) local slot of endpoint i
    ii_lj: np.ndarray  # (S, Eii) local slot of endpoint j
    ii_valid: np.ndarray  # (S, Eii)
    # int-sep edges, per submap; Hij oriented internal→separator
    is_edge: np.ndarray  # (S, Eis)
    is_li: np.ndarray  # (S, Eis) local internal slot
    is_sj: np.ndarray  # (S, Eis) separator slot
    is_transpose: np.ndarray  # (S, Eis) True if edge stored sep→int
    is_valid: np.ndarray  # (S, Eis)
    # sep-sep edges (global)
    ss_edge: np.ndarray  # (Ess,)
    ss_si: np.ndarray  # (Ess,)
    ss_sj: np.ndarray  # (Ess,)
    ss_valid: np.ndarray  # (Ess,)


_PART_ARRAY_FIELDS = [
    f.name for f in dataclasses.fields(SchurPartition)
    if f.name not in ("n_submaps", "n_nodes")
]

# pytree registration lets a partition be passed as a jit ARGUMENT (index
# maps change as the graph grows while their padded shapes stay stable, so
# compiled LM programs are reused instead of baking stale maps in as
# constants)
jax.tree_util.register_pytree_node(
    SchurPartition,
    lambda p: (
        tuple(getattr(p, n) for n in _PART_ARRAY_FIELDS),
        (p.n_submaps, p.n_nodes),
    ),
    lambda aux, ch: SchurPartition(
        aux[0], aux[1], **dict(zip(_PART_ARRAY_FIELDS, ch))
    ),
)


def _pad2(rows: list[np.ndarray], fill=0) -> np.ndarray:
    n = max((len(r) for r in rows), default=0)
    n = max(n, 1)
    out = np.full((len(rows), n), fill, dtype=np.int64)
    for k, r in enumerate(rows):
        out[k, : len(r)] = r
    return out


def build_partition(
    ei: np.ndarray,
    ej: np.ndarray,
    edge_valid: np.ndarray,
    n_nodes: int,
    n_submaps: int,
) -> SchurPartition:
    """Contiguous-block partition with separator promotion.

    Scans arrive in trajectory order, so contiguous blocks are the natural
    submaps (odometry/chain edges stay internal); only loop closures and
    block boundaries promote nodes into the separator set.
    """
    ei = np.asarray(ei, np.int64)
    ej = np.asarray(ej, np.int64)
    ev = np.asarray(edge_valid, bool)
    S = n_submaps
    block_size = -(-n_nodes // S)  # ceil
    blk = np.minimum(np.arange(n_nodes) // block_size, S - 1)

    cross = ev & (blk[ei] != blk[ej])
    sep_set = np.unique(np.concatenate([ei[cross], ej[cross]])) if cross.any() else np.empty(0, np.int64)
    is_sep = np.zeros(n_nodes, bool)
    is_sep[sep_set] = True

    # internal slots per submap + local index map
    local = np.full(n_nodes, -1, np.int64)
    int_rows = []
    for k in range(S):
        nodes = np.where((blk == k) & ~is_sep)[0]
        local[nodes] = np.arange(len(nodes))
        int_rows.append(nodes)
    int_nodes = _pad2(int_rows)
    m = int_nodes.shape[1]
    int_valid = np.zeros((S, m), bool)
    for k, r in enumerate(int_rows):
        int_valid[k, : len(r)] = True

    sep_local = np.full(n_nodes, -1, np.int64)
    sep_local[sep_set] = np.arange(len(sep_set))
    ns = max(len(sep_set), 1)
    sep_nodes = np.zeros(ns, np.int64)
    sep_nodes[: len(sep_set)] = sep_set
    sep_valid = np.zeros(ns, bool)
    sep_valid[: len(sep_set)] = True

    # classify edges
    E = len(ei)
    kind_int = ~is_sep
    ii_e, ii_i, ii_j = [[] for _ in range(S)], [[] for _ in range(S)], [[] for _ in range(S)]
    is_e, is_i, is_j, is_t = (
        [[] for _ in range(S)], [[] for _ in range(S)],
        [[] for _ in range(S)], [[] for _ in range(S)],
    )
    ss_e, ss_i, ss_j = [], [], []
    for e in range(E):
        if not ev[e]:
            continue
        a, b = ei[e], ej[e]
        ia, ib = kind_int[a], kind_int[b]
        if ia and ib:
            assert blk[a] == blk[b], "internal-internal edge crosses submaps"
            k = blk[a]
            ii_e[k].append(e)
            ii_i[k].append(local[a])
            ii_j[k].append(local[b])
        elif ia and not ib:
            k = blk[a]
            is_e[k].append(e)
            is_i[k].append(local[a])
            is_j[k].append(sep_local[b])
            is_t[k].append(0)
        elif ib and not ia:
            k = blk[b]
            is_e[k].append(e)
            is_i[k].append(local[b])
            is_j[k].append(sep_local[a])
            is_t[k].append(1)  # Hij is sep→int; transpose into B
        else:
            ss_e.append(e)
            ss_i.append(sep_local[a])
            ss_j.append(sep_local[b])

    def valid2(rows):
        arr = _pad2(rows)
        v = np.zeros(arr.shape, bool)
        for k, r in enumerate(rows):
            v[k, : len(r)] = True
        return arr, v

    ii_edge, ii_valid = valid2(ii_e)
    is_edge, is_valid = valid2(is_e)
    Ess = max(len(ss_e), 1)
    ss_edge = np.zeros(Ess, np.int64)
    ss_edge[: len(ss_e)] = ss_e
    ss_valid = np.zeros(Ess, bool)
    ss_valid[: len(ss_e)] = True
    ss_si = np.zeros(Ess, np.int64)
    ss_si[: len(ss_i)] = ss_i
    ss_sj = np.zeros(Ess, np.int64)
    ss_sj[: len(ss_j)] = ss_j

    def i32(a):
        return a.astype(np.int32) if a.dtype != bool else a

    return SchurPartition(
        n_submaps=S,
        n_nodes=n_nodes,
        int_nodes=i32(int_nodes),
        int_valid=int_valid,
        sep_nodes=i32(sep_nodes),
        sep_valid=sep_valid,
        ii_edge=i32(ii_edge),
        ii_li=i32(_pad2(ii_i)),
        ii_lj=i32(_pad2(ii_j)),
        ii_valid=ii_valid,
        is_edge=i32(is_edge),
        is_li=i32(_pad2(is_i)),
        is_sj=i32(_pad2(is_j)),
        is_transpose=_pad2(is_t).astype(bool),
        is_valid=is_valid,
        ss_edge=i32(ss_edge),
        ss_si=i32(ss_si),
        ss_sj=i32(ss_sj),
        ss_valid=ss_valid,
    )


def bucket_partition(
    part: SchurPartition, min_width: int = 16
) -> SchurPartition:
    """Pad every data-dependent partition width up to a power-of-two bucket.

    `build_partition` pads to the exact max row length, so the padded shapes
    change whenever the graph grows — and since the LM device program is
    cached by shape, every loop closure of a growing mission would trigger
    a fresh compile. Bucketing makes
    the shapes step only at power-of-two crossings; pad slots carry index 0
    + valid=False, exactly the convention the device program already
    guards (identity gauge rows, `mode="drop"` scatters)."""

    def _b(n: int) -> int:
        b = min_width
        while b < n:
            b *= 2
        return b

    def pad_last(a: np.ndarray, fill=0) -> np.ndarray:
        w = _b(a.shape[-1])
        if w == a.shape[-1]:
            return a
        pad = [(0, 0)] * (a.ndim - 1) + [(0, w - a.shape[-1])]
        return np.pad(a, pad, constant_values=fill)

    return dataclasses.replace(
        part,
        **{
            name: pad_last(np.asarray(getattr(part, name)))
            for name in _PART_ARRAY_FIELDS
        },
    )


def _damped_diag(Hd, lam):
    eye3 = jnp.eye(3, dtype=Hd.dtype)
    Hd = Hd + 1e-12 * eye3
    return Hd.at[..., jnp.arange(3), jnp.arange(3)].mul(1.0 + lam)


def _scatter_blocks(Aflat, bi, bj, blocks):
    """Aflat[3·bi+r, 3·bj+c] += blocks[e, r, c] — 3×3 block scatter into a
    FLAT (3n, 3n) matrix. The block form ((n, 3, n, 3) etc.) puts a
    trailing dimension of 3 where device layouts pad to tiles, which
    multiplies the memory of a large separator system."""
    r = jnp.arange(3)
    R = 3 * bi[:, None, None] + r[None, :, None]
    C = 3 * bj[:, None, None] + r[None, None, :]
    return Aflat.at[R, C].add(blocks)


def _assemble_submap_AB(
    Hdd, Hij, free_mask, int_nodes, int_valid,
    ii_edge, ii_li, ii_lj, ii_valid,
    is_edge, is_li, is_sj, is_transpose, is_valid,
    ns,
):
    """Shared per-submap assembly: gauge-fixed internal block A (3m, 3m)
    and internal→separator coupling B (3m, 3ns), both FLAT (see
    _scatter_blocks). Single source of truth for the f32 solve path
    (_submap_local) AND the mixed-precision factor path (schur_factor) —
    a fix to either assembly must land in both."""
    dt = Hdd.dtype
    m = int_nodes.shape[0]

    fm_int = (int_valid & free_mask[int_nodes]).astype(dt)  # (m,)
    fm3 = jnp.repeat(fm_int, 3)  # (3m,)

    im = jnp.arange(m)
    A = jnp.zeros((3 * m, 3 * m), dt)
    A = _scatter_blocks(A, im, im, Hdd[int_nodes])
    wii = ii_valid.astype(dt)[:, None, None]
    Hii = Hij[ii_edge] * wii
    A = _scatter_blocks(A, ii_li, ii_lj, Hii)
    A = _scatter_blocks(A, ii_lj, ii_li, jnp.swapaxes(Hii, -1, -2))
    # gauge/pad: zero rows+cols, identity diagonal (mirrors dense_solve)
    A = A * fm3[:, None] * fm3[None, :]
    A = A + jnp.diag(1.0 - fm3)

    wis = is_valid.astype(dt)[:, None, None]
    His = Hij[is_edge]
    His = jnp.where(
        is_transpose[:, None, None], jnp.swapaxes(His, -1, -2), His
    ) * wis
    B = jnp.zeros((3 * m, 3 * ns), dt)
    B = _scatter_blocks(B, is_li, is_sj, His)
    # internal-side gauge; the separator-side mask is applied by the caller
    # on the reduced system (fixed separators get zero columns there)
    B = B * fm3[:, None]
    return A, B, fm_int


def _submap_local(
    Hdd, Hij, b, free_mask, int_nodes, int_valid,
    ii_edge, ii_li, ii_lj, ii_valid,
    is_edge, is_li, is_sj, is_transpose, is_valid,
    ns,
):
    """Per-submap dense assembly + factorization + Schur contribution.

    All inputs are this submap's slices (no leading S axis). Returns
    (Sc_part (3ns, 3ns), rhs_part (3ns,), y (3m,), YB (3m, 3ns),
    fm_int (m,)). All matrices assembled FLAT (see _scatter_blocks).
    """
    m = int_nodes.shape[0]
    A, B, fm_int = _assemble_submap_AB(
        Hdd, Hij, free_mask, int_nodes, int_valid,
        ii_edge, ii_li, ii_lj, ii_valid,
        is_edge, is_li, is_sj, is_transpose, is_valid, ns,
    )
    bi = (b[int_nodes] * fm_int[:, None]).reshape(3 * m)

    L = jax.scipy.linalg.cho_factor(A)
    rhs = jnp.concatenate([B, bi[:, None]], axis=1)
    sol = jax.scipy.linalg.cho_solve(L, rhs)
    YB = sol[:, : 3 * ns]  # A⁻¹ B
    y = sol[:, 3 * ns]  # A⁻¹ b_int
    Sc_part = B.T @ YB
    rhs_part = B.T @ y
    return Sc_part, rhs_part, y, YB, fm_int


def _sep_system(part, Hdd, Hij, b, free_mask, ns):
    """Replicated separator-side pieces: damped gauge-fixed C and b_sep.
    Assembly shared with the factor path via _sep_matrix."""
    C, fm_sep, _fm3 = _sep_matrix(part, Hdd, Hij, free_mask, ns)
    b_sep = b[jnp.asarray(part.sep_nodes)] * fm_sep[:, None]
    return C, b_sep.reshape(-1), fm_sep


def _sep_matrix(part, Hdd, Hij, free_mask, ns):
    """Separator-side matrix C (damped, gauge-fixed, FLAT) + masks."""
    dt = Hdd.dtype
    sep_nodes = jnp.asarray(part.sep_nodes)
    fm_sep = (
        jnp.asarray(part.sep_valid) & free_mask[sep_nodes]
    ).astype(dt)
    fm3 = jnp.repeat(fm_sep, 3)
    isn = jnp.arange(ns)
    C = jnp.zeros((3 * ns, 3 * ns), dt)
    C = _scatter_blocks(C, isn, isn, Hdd[sep_nodes])
    wss = jnp.asarray(part.ss_valid).astype(dt)[:, None, None]
    Hss = Hij[jnp.asarray(part.ss_edge)] * wss
    si = jnp.asarray(part.ss_si)
    sj = jnp.asarray(part.ss_sj)
    C = _scatter_blocks(C, si, sj, Hss)
    C = _scatter_blocks(C, sj, si, jnp.swapaxes(Hss, -1, -2))
    C = C * fm3[:, None] * fm3[None, :]
    C = C + jnp.diag(1.0 - fm3)
    return C, fm_sep, fm3


def schur_factor(part: SchurPartition, Hdd, Hij, free_mask):
    """Factor the damped gauge-fixed system ONCE; reuse via schur_apply.

    Built for the mixed-precision large-graph path
    (pose_graph.mixed_schur_delta): all factorizations run in f32, while
    the caller's f64 PCG restores exact deltas using only matvecs. Returns
    (L_sub (S,3m,3m), B (S,3m,3ns), YB (S,3m,3ns), fm_int (S,m),
    L_sc (3ns,3ns), fm_sep, colmask)."""
    dt = Hdd.dtype
    ns = part.sep_nodes.shape[0]

    def _one(Sc_acc, inp):
        (a, v, iie, iili, iilj, iiv, ise, isli, issj, ist, isv) = inp
        A, B, fm_int = _assemble_submap_AB(
            Hdd, Hij, free_mask, a, v, iie, iili, iilj, iiv,
            ise, isli, issj, ist, isv, ns,
        )
        L, _ = jax.scipy.linalg.cho_factor(A)
        YB = jax.scipy.linalg.cho_solve((L, False), B)
        return Sc_acc + B.T @ YB, (L, B, YB, fm_int)

    Sc_sum, (Ls, Bs, YBs, fm_int) = jax.lax.scan(
        _one,
        jnp.zeros((3 * ns, 3 * ns), dt),
        (
            jnp.asarray(part.int_nodes), jnp.asarray(part.int_valid),
            jnp.asarray(part.ii_edge), jnp.asarray(part.ii_li),
            jnp.asarray(part.ii_lj), jnp.asarray(part.ii_valid),
            jnp.asarray(part.is_edge), jnp.asarray(part.is_li),
            jnp.asarray(part.is_sj), jnp.asarray(part.is_transpose),
            jnp.asarray(part.is_valid),
        ),
    )
    C, fm_sep, colmask3 = _sep_matrix(part, Hdd, Hij, free_mask, ns)
    Sc = C - Sc_sum * colmask3[None, :] * colmask3[:, None]
    Lsc, _ = jax.scipy.linalg.cho_factor(Sc)
    return (Ls, Bs, YBs, fm_int, Lsc, fm_sep, colmask3)


def schur_apply(part: SchurPartition, fac, rhs, free_mask):
    """x = H⁻¹ rhs for the damped gauge-fixed H captured by the factor.

    rhs: (M, 3). Returns (M, 3). Standard arrow back-substitution:
    y_k = A_k⁻¹ r_k;  Sc x_sep = r_sep − Σ B_kᵀ y_k;
    x_k = y_k − (A_k⁻¹B_k) x_sep."""
    Ls, Bs, YBs, fm_int, Lsc, fm_sep, colmask3 = fac
    dt = Ls.dtype
    M = part.n_nodes
    ns = part.sep_nodes.shape[0]
    int_nodes = jnp.asarray(part.int_nodes)
    int_valid = jnp.asarray(part.int_valid)

    def _one(acc, inp):
        L, B, fmi, a = inp
        ri = (rhs[a] * fmi[:, None]).reshape(-1).astype(dt)
        y = jax.scipy.linalg.cho_solve((L, False), ri)
        return acc + B.T @ y, y

    acc, ys = jax.lax.scan(
        _one, jnp.zeros((3 * ns,), dt), (Ls, Bs, fm_int, int_nodes)
    )
    r_sep = (
        rhs[jnp.asarray(part.sep_nodes)] * fm_sep[:, None]
    ).reshape(-1).astype(dt)
    x_sep = jax.scipy.linalg.cho_solve(
        (Lsc, False), (r_sep - acc) * colmask3
    ) * colmask3
    x_int = ys - jnp.einsum("sij,j->si", YBs, x_sep)
    S, m3 = x_int.shape
    x_int = x_int.reshape(S, m3 // 3, 3) * fm_int[..., None]

    x = jnp.zeros((M, 3), dt)
    inodes = jnp.where(int_valid, int_nodes, M)
    x = x.at[inodes.reshape(-1)].add(x_int.reshape(-1, 3), mode="drop")
    snodes = jnp.where(
        jnp.asarray(part.sep_valid), jnp.asarray(part.sep_nodes), M
    )
    x = x.at[snodes].add(
        x_sep.reshape(-1, 3) * fm_sep[:, None], mode="drop"
    )
    return x


def schur_delta(
    part: SchurPartition,
    poses,
    ei,
    ej,
    means,
    infos,
    mask,
    lam,
    free_mask,
):
    """Single-program Schur solve of the LM step (submaps batched by vmap).

    Same system as `dense_solve` (damping diag·(1+λ), gauge-fixed rows);
    returns δ (M, 3). Use inside jit.
    """
    M = part.n_nodes
    Hd, Hij, b = normal_equations(poses, ei, ej, means, infos, mask, M)
    Hdd = _damped_diag(Hd, lam)
    ns = part.sep_nodes.shape[0]

    # scan (not vmap) over submaps: vmap materializes every submap's
    # (3ns, 3ns) Schur contribution at once — at outdoor separator counts
    # (ns ≈ 1k once long-lever anchor edges cross submap boundaries) that
    # is S × 37-75 MB, and XLA's rematerialized copies OOM'd HBM (round
    # 4: two 9 GB broadcasts). The scan accumulates Sc/rhs in O(1) and
    # stacks only the (3m, 3ns) back-substitution factors.
    def _one(_, inp):
        (a, v, iie, iili, iilj, iiv, ise, isli, issj, ist, isv) = inp
        Sc_p, rhs_p, y, YB, fm_int = _submap_local(
            Hdd, Hij, b, free_mask, a, v,
            iie, iili, iilj, iiv, ise, isli, issj, ist, isv, ns,
        )
        Sc_acc, rhs_acc = _
        return (Sc_acc + Sc_p, rhs_acc + rhs_p), (y, YB, fm_int)

    dt = Hdd.dtype
    (Sc_sum, rhs_sum), (y, YB, fm_int) = jax.lax.scan(
        _one,
        (jnp.zeros((3 * ns, 3 * ns), dt), jnp.zeros((3 * ns,), dt)),
        (
            jnp.asarray(part.int_nodes), jnp.asarray(part.int_valid),
            jnp.asarray(part.ii_edge), jnp.asarray(part.ii_li),
            jnp.asarray(part.ii_lj), jnp.asarray(part.ii_valid),
            jnp.asarray(part.is_edge), jnp.asarray(part.is_li),
            jnp.asarray(part.is_sj), jnp.asarray(part.is_transpose),
            jnp.asarray(part.is_valid),
        ),
    )

    C, b_sep, fm_sep = _sep_system(part, Hdd, Hij, b, free_mask, ns)
    # apply separator gauge to the reduced contributions as well: B columns
    # of fixed separators must vanish
    colmask = jnp.repeat(fm_sep, 3)
    Sc = C - Sc_sum * colmask[None, :] * colmask[:, None]
    rhs = -b_sep + rhs_sum * colmask
    d_sep = jax.scipy.linalg.cho_solve(
        jax.scipy.linalg.cho_factor(Sc), rhs
    )  # (3ns,)
    d_sep = d_sep * colmask

    # back-substitution per submap: δ_int = −y − (A⁻¹B) δ_sep
    d_int = -y - jnp.einsum("sij,j->si", YB, d_sep)  # (S, 3m)
    S, m3 = d_int.shape
    d_int = d_int.reshape(S, m3 // 3, 3) * fm_int[..., None]

    delta = jnp.zeros((M, 3), poses.dtype)
    iv = jnp.asarray(part.int_valid)
    inodes = jnp.where(iv, jnp.asarray(part.int_nodes), M)  # pad → dropped
    delta = delta.at[inodes.reshape(-1)].add(
        d_int.reshape(-1, 3), mode="drop"
    )
    snodes = jnp.where(
        jnp.asarray(part.sep_valid), jnp.asarray(part.sep_nodes), M
    )
    delta = delta.at[snodes].add(
        d_sep.reshape(-1, 3) * fm_sep[:, None], mode="drop"
    )
    return delta


def make_distributed_schur_delta(
    mesh: Mesh, part: SchurPartition, axis: str = "data"
):
    """Submap-sharded Schur solve: local factorizations on each device's
    submap shard, ONE psum of the (3·n_sep)² separator system over the mesh
    axis, replicated separator solve, local back-substitution.

    Requires part.n_submaps == mesh.shape[axis] (one submap per device; use
    more submaps per device by vmapping inside — see schur_delta)."""
    assert part.n_submaps == mesh.shape[axis], (
        "one submap per device on the mesh axis"
    )
    ns = part.sep_nodes.shape[0]
    M = part.n_nodes

    def step(poses, ei, ej, means, infos, mask, lam, free_mask):
        # graph inputs are replicated (normal-equation assembly is duplicated
        # on every device — cheap relative to the factorization; a multi-host
        # deployment would shard the edges and psum Hd/b as in
        # make_distributed_lm_delta). The partition arrays are compile-time
        # constants, sliced per device by axis_index.
        Hd, Hij, b = normal_equations(
            poses, ei, ej, means, infos, mask, M
        )
        Hdd = _damped_diag(Hd, lam)
        C, b_sep, fm_sep = _sep_system(part, Hdd, Hij, b, free_mask, ns)
        colmask = jnp.repeat(fm_sep, 3)

        k = jax.lax.axis_index(axis)
        take = lambda arr: jnp.asarray(arr)[k]
        Sc_p, rhs_p, y, YB, fm_int = _submap_local(
            Hdd, Hij, b, free_mask,
            take(part.int_nodes), take(part.int_valid),
            take(part.ii_edge), take(part.ii_li),
            take(part.ii_lj), take(part.ii_valid),
            take(part.is_edge), take(part.is_li),
            take(part.is_sj), take(part.is_transpose),
            take(part.is_valid), ns,
        )
        # the ONE collective of the solve: reduce the separator system
        Sc_sum = jax.lax.psum(Sc_p, axis)
        rhs_sum = jax.lax.psum(rhs_p, axis)
        Sc = C - Sc_sum * colmask[None, :] * colmask[:, None]
        rhs = -b_sep + rhs_sum * colmask
        d_sep = jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Sc), rhs
        ) * colmask  # replicated: every device solves the small system

        # local back-substitution, then psum-assemble the replicated delta
        d_int = (-y - YB @ d_sep).reshape(-1, 3) * fm_int[:, None]
        delta_loc = jnp.zeros((M, 3), poses.dtype)
        inodes = jnp.where(take(part.int_valid), take(part.int_nodes), M)
        delta_loc = delta_loc.at[inodes].add(d_int, mode="drop")
        delta = jax.lax.psum(delta_loc, axis)
        snodes = jnp.where(
            jnp.asarray(part.sep_valid), jnp.asarray(part.sep_nodes), M
        )
        delta = delta.at[snodes].add(
            d_sep.reshape(-1, 3) * fm_sep[:, None], mode="drop"
        )
        return delta

    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(),) * 8,
            out_specs=P(),
        )
    )
