"""Pose-graph optimisation (loop-closure relinearisation).

NEW vs the reference (SURVEY.md §5). Nodes are keyframe poses, edges are
relative-pose measurements (sequential VO edges + loop-closure edges from
backend/loop_closure.py). Gauss-Newton on the se(3) residual
r_e = log(Z_e^-1 · X_i^-1 · X_j) under left-multiplicative twists
X <- exp(xi) X, with ANALYTIC block Jacobians:

    err(xi) = Z^-1 X_i^-1 exp(xi_j - xi_i) X_j            (first order)
            = err_0 · exp(Adj(X_j^-1)(xi_j - xi_i))
    =>  J_j = Jr^-1(r_0) · Adj(X_j^-1),   J_i = -J_j

with Jr^-1(r) ≈ I + ad(r)/2 (the standard second-order right-Jacobian
inverse).

Edge weights are general 6x6 information matrices (scalar and 6-vector
diagonal forms broadcast): cost_e = r^T W_e r. This is what lets a
scale-free monocular loop edge constrain rotation + translation DIRECTION
while carrying zero information along the measured translation axis
(backend/refine.py builds that projector) instead of pulling |t| toward a
magnitude copied from the drifting trajectory.

Solver: block-sparse preconditioned conjugate gradient (default). The
Gauss-Newton normal system is never materialised as an (M·6, M·6) matrix —
only per-edge 6x6 blocks B_e = J_e^T W_e J_e (the same quantity for all four
H blocks of an edge, since J_i = -J_j) and the block diagonal live in memory,
so cost and memory are O(edges) and the Hessian-vector product

    (Hx)_i += B_e (x_i - x_j),  (Hx)_j -= B_e (x_i - x_j)

is a gather / 6x6 batched matvec / scatter-add — exactly the unit that
shards across a device mesh: `optimize(..., mesh=...)` splits the edge set
over devices and psums the partial products across devices (shard_map), with the
tiny (M, 6) CG state replicated. A dense Cholesky solve is kept as
cfg.solver='dense' for cross-checking on small graphs.

Fixed shapes: edges are padded arrays with a weight mask (zero-weight edges
contribute nothing to cost, gradient, or preconditioner).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from droplet_visual_odometry_tpu.core import se3


@dataclasses.dataclass(frozen=True)
class PoseGraphConfig:
    iters: int = 10
    damping: float = 1e-6
    solver: str = "pcg"  # 'pcg' (block-sparse, O(edges)) | 'dense'
    cg_iters: int = 100  # CG iteration cap per GN step
    cg_tol: float = 1e-8  # relative residual-norm^2 stop


class PoseGraph(NamedTuple):
    poses: jax.Array  # (M, 4, 4) node poses (world_T_node)
    edge_i: jax.Array  # (E,) int32 source node
    edge_j: jax.Array  # (E,) int32 target node
    edge_meas: jax.Array  # (E, 4, 4) measured node_i_T_node_j
    edge_weight: jax.Array  # (E,) | (E, 6) | (E, 6, 6) information (0 = padding)


class PoseGraphResult(NamedTuple):
    poses: jax.Array
    initial_cost: jax.Array
    final_cost: jax.Array


def weight_matrices(edge_weight: jax.Array, dtype=jnp.float32) -> jax.Array:
    """Normalise scalar / diagonal / full edge weights to (E, 6, 6)."""
    w = jnp.asarray(edge_weight, dtype)
    if w.ndim == 1:  # scalar per edge -> w * I6
        return w[:, None, None] * jnp.eye(6, dtype=dtype)
    if w.ndim == 2:  # diagonal per edge
        return jax.vmap(jnp.diag)(w)
    if w.ndim == 3:
        return w
    raise ValueError(f"edge_weight must be (E,), (E,6) or (E,6,6); got {w.shape}")


def _edge_residuals(poses: jax.Array, graph: PoseGraph) -> jax.Array:
    """(E, 6) unweighted residuals r_e = log(Z^-1 X_i^-1 X_j)."""
    Xi = poses[graph.edge_i]
    Xj = poses[graph.edge_j]
    rel = se3.inverse(Xi) @ Xj
    return se3.se3_log(se3.inverse(graph.edge_meas) @ rel)


def cost(graph: PoseGraph) -> jax.Array:
    r = _edge_residuals(graph.poses, graph)
    W = weight_matrices(graph.edge_weight, graph.poses.dtype)
    return jnp.sum(r * jnp.einsum("eab,eb->ea", W, r))


def _edge_blocks(poses: jax.Array, graph: PoseGraph):
    """Per-edge weighted normal blocks.

    Returns (B, g) with B = J_j^T W J_j (E, 6, 6) and g = J_j^T W r (E, 6).
    With J_i = -J_j these generate every H block and gradient entry of the
    edge: H_ii = H_jj = B, H_ij = H_ji = -B, b_i = +g, b_j = -g.
    """
    r = _edge_residuals(poses, graph)  # (E, 6)
    Xj = poses[graph.edge_j]
    I6 = jnp.eye(6, dtype=poses.dtype)
    Jr_inv = I6 + 0.5 * se3.ad(r)
    Jj = Jr_inv @ se3.adjoint(se3.inverse(Xj))  # (E, 6, 6)
    W = weight_matrices(graph.edge_weight, poses.dtype)
    WJj = W @ Jj
    B = jnp.swapaxes(Jj, -1, -2) @ WJj
    g = jnp.einsum("ekh,ek->eh", WJj, r)
    return B, g


def _gauge_mask(M: int, dtype) -> jax.Array:
    """(M, 6) multiplier fixing node 0 (the gauge)."""
    return (jnp.arange(M) >= 1).astype(dtype)[:, None] * jnp.ones((1, 6), dtype)


def _assemble_rhs_diag(M: int, graph: PoseGraph, B: jax.Array, g: jax.Array):
    """Scatter-add the gradient (M, 6) and the block diagonal (M, 6, 6)."""
    ei, ej = graph.edge_i, graph.edge_j
    b = jnp.zeros((M, 6), B.dtype).at[ei].add(g).at[ej].add(-g)
    D = jnp.zeros((M, 6, 6), B.dtype).at[ei].add(B).at[ej].add(B)
    return b, D


def _hx_local(B: jax.Array, ei: jax.Array, ej: jax.Array, x: jax.Array) -> jax.Array:
    """Edge-local part of the Hessian-vector product (no damping/gauge)."""
    y = jnp.einsum("eab,eb->ea", B, x[ei] - x[ej])  # (E, 6)
    return jnp.zeros_like(x).at[ei].add(y).at[ej].add(-y)


def _pcg(matvec, b: jax.Array, Minv: jax.Array, iters: int, tol: float) -> jax.Array:
    """Block-preconditioned CG: solve H x = b with M^-1 given as (M, 6, 6)."""

    def apply_minv(r):
        return jnp.einsum("mab,mb->ma", Minv, r)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = apply_minv(r0)
    rz0 = jnp.sum(r0 * z0)
    stop = tol * jnp.maximum(jnp.sum(b * b), 1e-30)

    def cond(state):
        k, _, r, _, _ = state
        return (k < iters) & (jnp.sum(r * r) > stop)

    def body(state):
        k, x, r, z, p = state
        Hp = matvec(p)
        rz = jnp.sum(r * z)
        alpha = rz / jnp.maximum(jnp.sum(p * Hp), 1e-30)
        x = x + alpha * p
        r = r - alpha * Hp
        z_new = apply_minv(r)
        beta = jnp.sum(r * z_new) / jnp.maximum(rz, 1e-30)
        p = z_new + beta * p
        return k + 1, x, r, z_new, p

    _, x, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, z0, z0))
    return x


def _solve_dense(M, graph, B, g, damping):
    """Reference dense solve (small graphs / cross-checking)."""
    b, _ = _assemble_rhs_diag(M, graph, B, g)
    ei, ej = graph.edge_i, graph.edge_j
    H = jnp.zeros((M, M, 6, 6), B.dtype)
    H = H.at[ei, ei].add(B)
    H = H.at[ej, ej].add(B)
    H = H.at[ei, ej].add(-B)
    H = H.at[ej, ei].add(-B)
    Hd = H.transpose(0, 2, 1, 3).reshape(M * 6, M * 6)
    bd = b.reshape(M * 6)
    mask = (jnp.arange(M * 6) >= 6).astype(Hd.dtype)
    Hd = Hd * mask[:, None] * mask[None, :]
    Hd = Hd + jnp.diag(jnp.where(mask > 0, damping, 1.0))
    return jnp.linalg.solve(Hd, bd * mask).reshape(M, 6)


def _solve_pcg(M, graph, B, g, cfg: PoseGraphConfig, mesh: Mesh | None):
    b, D = _assemble_rhs_diag(M, graph, B, g)
    gm = _gauge_mask(M, B.dtype)
    b = b * gm
    # Block-Jacobi preconditioner; gauge row gets the identity (its residual
    # is identically zero so CG never moves it).
    D = D + cfg.damping * jnp.eye(6, dtype=B.dtype)
    D = D.at[0].set(jnp.eye(6, dtype=B.dtype))
    Minv = jnp.linalg.inv(D)

    if mesh is None:
        hx_edges = lambda x: _hx_local(B, graph.edge_i, graph.edge_j, x)
    else:
        n_dev = mesh.devices.size
        axis = mesh.axis_names[0]
        E = B.shape[0]
        pad = (-E) % n_dev
        # Zero-weight padding edges between node 0 and itself: B_pad = 0 so
        # they contribute nothing to the product.
        Bp = jnp.concatenate([B, jnp.zeros((pad, 6, 6), B.dtype)], axis=0)
        eip = jnp.concatenate([graph.edge_i, jnp.zeros(pad, graph.edge_i.dtype)])
        ejp = jnp.concatenate([graph.edge_j, jnp.zeros(pad, graph.edge_j.dtype)])

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(axis), P(axis), P(axis), P()),
            out_specs=P(),
        )
        def hx_sharded(Bs, eis, ejs, x):
            return jax.lax.psum(_hx_local(Bs, eis, ejs, x), axis)

        hx_edges = lambda x: hx_sharded(Bp, eip, ejp, x)

    def matvec(x):
        x = x * gm
        return hx_edges(x) * gm + cfg.damping * x

    return _pcg(matvec, b, Minv, cfg.cg_iters, cfg.cg_tol)


def optimize(
    graph: PoseGraph,
    cfg: PoseGraphConfig = PoseGraphConfig(),
    mesh: Mesh | None = None,
) -> PoseGraphResult:
    """Gauss-Newton with the first node held fixed (gauge). Jittable.

    mesh: optional device mesh — the per-GN-step Hessian-vector products run
    edge-sharded over it (weak-scales with edge count; CG state replicated).
    """
    initial = cost(graph)

    def gn_step(_, carry):
        poses, cur_cost = carry
        B, g = _edge_blocks(poses, graph)
        M = poses.shape[0]
        if cfg.solver == "dense":
            dx = _solve_dense(M, graph, B, g, cfg.damping)
        elif cfg.solver == "pcg":
            dx = _solve_pcg(M, graph, B, g, cfg, mesh)
        else:
            raise ValueError(f"unknown pose-graph solver: {cfg.solver}")
        # b accumulated -grad blocks (b_i = +J_j^T W r = -grad_i), so dx is
        # already the descent step.
        new_poses = se3.se3_exp(dx) @ poses
        new_cost = cost(graph._replace(poses=new_poses))
        ok = (new_cost < cur_cost) & jnp.isfinite(new_cost)
        poses = jnp.where(ok, new_poses, poses)
        cur_cost = jnp.where(ok, new_cost, cur_cost)
        return poses, cur_cost

    poses, final = jax.lax.fori_loop(0, cfg.iters, gn_step, (graph.poses, initial))
    return PoseGraphResult(poses=poses, initial_cost=initial, final_cost=final)


# Module-level jitted entry: callers MUST use this (not a fresh jax.jit per
# call, which would carry a fresh trace cache) for the shape-bucketing in
# pad_graph to actually bound retraces across calls. `mesh` is static
# (hashable); cfg is a frozen dataclass.
optimize_jit = jax.jit(optimize, static_argnames=("cfg", "mesh"))


def sequential_edges(poses: jax.Array, weight: float = 1.0) -> PoseGraph:
    """Build a chain pose graph from (M, 4, 4) poses: edges i -> i+1 with the
    current relative poses as measurements (zero residual by construction —
    loop-closure edges added on top are what create the correction signal)."""
    M = poses.shape[0]
    i = jnp.arange(M - 1, dtype=jnp.int32)
    j = i + 1
    meas = se3.inverse(poses[:-1]) @ poses[1:]
    w = jnp.full((M - 1,), weight, poses.dtype)
    return PoseGraph(poses=poses, edge_i=i, edge_j=j, edge_meas=meas, edge_weight=w)


def _as_weight_array(w, dtype) -> jax.Array:
    w = jnp.asarray(w, dtype)
    if w.ndim == 0:
        w = w[None]
    return w


def add_edges(
    graph: PoseGraph,
    i: jax.Array,
    j: jax.Array,
    meas: jax.Array,
    weight: jax.Array,
) -> PoseGraph:
    """Append (loop-closure) edges. `weight` may be scalar-per-edge (E,),
    diagonal (E, 6), or full information matrices (E, 6, 6); mixed forms are
    promoted to the more general one."""
    w_old = jnp.asarray(graph.edge_weight)
    w_new = _as_weight_array(weight, w_old.dtype)
    if w_old.ndim != w_new.ndim:
        rank = max(w_old.ndim, w_new.ndim)
        target = {1: None, 2: "diag", 3: "full"}[rank]
        if target == "diag":
            if w_old.ndim == 1:
                w_old = w_old[:, None] * jnp.ones((1, 6), w_old.dtype)
            if w_new.ndim == 1:
                w_new = w_new[:, None] * jnp.ones((1, 6), w_new.dtype)
        elif target == "full":
            w_old = weight_matrices(w_old, w_old.dtype)
            w_new = weight_matrices(w_new, w_new.dtype)
    return PoseGraph(
        poses=graph.poses,
        edge_i=jnp.concatenate([graph.edge_i, jnp.asarray(i, jnp.int32)]),
        edge_j=jnp.concatenate([graph.edge_j, jnp.asarray(j, jnp.int32)]),
        edge_meas=jnp.concatenate([graph.edge_meas, meas]),
        edge_weight=jnp.concatenate([w_old, w_new]),
    )


def next_bucket(n: int, floor: int = 16) -> int:
    """Smallest power-of-two >= max(n, floor) — the shape-bucketing rule that
    keeps `optimize` from retracing as a streaming map grows (VERDICT r3 weak
    #6): (M, E) land on O(log) distinct shapes instead of one per graph."""
    b = floor
    while b < n:
        b *= 2
    return b


def pad_graph(graph: PoseGraph, m_bucket: int, e_bucket: int) -> PoseGraph:
    """Pad to (m_bucket nodes, e_bucket edges) with inert filler.

    Padding nodes are identity poses with NO edges: their gradient is zero
    and block-Jacobi preconditioned CG provably never moves a coordinate with
    zero residual, so the solution on the real nodes is bit-identical to the
    unpadded solve. Padding edges are zero-weight self-loops on node 0 (the
    same scheme _solve_pcg already uses for mesh-divisibility padding) — they
    contribute nothing to cost, gradient, or preconditioner. Slice
    `result.poses[:M]` to recover the real nodes.
    """
    M = graph.poses.shape[0]
    E = graph.edge_i.shape[0]
    if m_bucket < M or e_bucket < E:
        raise ValueError(f"bucket smaller than graph: {(m_bucket, e_bucket)} < {(M, E)}")
    if m_bucket == M and e_bucket == E:
        return graph
    dtype = graph.poses.dtype
    poses = jnp.concatenate(
        [graph.poses, jnp.broadcast_to(jnp.eye(4, dtype=dtype), (m_bucket - M, 4, 4))]
    )
    pe = e_bucket - E
    w = jnp.asarray(graph.edge_weight)
    w_pad = jnp.zeros((pe,) + w.shape[1:], w.dtype)
    return PoseGraph(
        poses=poses,
        edge_i=jnp.concatenate([graph.edge_i, jnp.zeros(pe, graph.edge_i.dtype)]),
        edge_j=jnp.concatenate([graph.edge_j, jnp.zeros(pe, graph.edge_j.dtype)]),
        edge_meas=jnp.concatenate(
            [graph.edge_meas, jnp.broadcast_to(jnp.eye(4, dtype=dtype), (pe, 4, 4))]
        ),
        edge_weight=jnp.concatenate([w, w_pad]),
    )


def scale_free_weight(
    meas: jax.Array, w_rot: float, w_dir: float
) -> jax.Array:
    """(E, 6, 6) information matrix for monocular scale-free loop edges.

    Full rotation information, and translation information only ORTHOGONAL to
    the measured translation direction (expressed in the measurement's target
    frame, where the residual's translation component lives to first order):
    the edge constrains bearing + rotation while carrying zero information
    along |t| — no trajectory-implied magnitude is needed (VERDICT r2 #6).
    """
    t = jnp.einsum("...ba,...b->...a", se3.rotation(meas), se3.translation(meas))
    u = t / jnp.maximum(jnp.linalg.norm(t, axis=-1, keepdims=True), 1e-12)
    I3 = jnp.eye(3, dtype=meas.dtype)
    proj = I3 - u[..., :, None] * u[..., None, :]
    W = jnp.zeros(meas.shape[:-2] + (6, 6), meas.dtype)
    W = W.at[..., :3, :3].set(w_dir * proj)
    W = W.at[..., 3:, 3:].set(w_rot * I3)
    return W
