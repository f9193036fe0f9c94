"""Device-mesh sharding of ensembles.

The ensemble batch axis is embarrassingly parallel: shard it over a flat
1-D mesh and XLA runs each shard's lockstep solver locally with zero
inner-loop collectives (norms and convergence tests are per-instance) —
exactly the layout SURVEY.md §2.2 calls for. Large single systems
(sharded state vectors + SPGMR with psum reductions) ride the same mesh
via the Krylov path (ops/spgmr.py).
"""

from __future__ import annotations

import re

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.state import IdaState


_COLLECTIVE_RE = re.compile(
    r"=\s*(\(.*?\)|\S+)\s+(all-reduce|all-gather|reduce-scatter|"
    r"collective-permute|all-to-all)(-start|-done)?\("
)


def data_collectives(hlo_text: str, allow_scalar: bool = True) -> list[str]:
    """The collective instructions of a compiled HLO module that move
    array data: every all-reduce / all-gather / reduce-scatter /
    collective-permute / all-to-all (and its async ``-start``/``-done``
    halves) whose result holds a non-scalar array. With ``allow_scalar``,
    scalar collectives — the ``pred[]`` all-reduces of a global while-loop
    condition, alone or combined into a tuple — move one element per loop
    trip and are not reported; without it every collective is."""
    bad = []
    for line in hlo_text.splitlines():
        m = _COLLECTIVE_RE.search(line)
        if m is None:
            continue
        dims = re.findall(r"\w+\[([^\]]*)\]", m.group(1))
        if not allow_scalar or any(d.strip() for d in dims):
            bad.append(line.strip()[:160])
    return bad


def make_mesh(n_devices: int | None = None, axis: str = "batch") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def shard_ensemble(states: IdaState, mesh: Mesh, axis: str = "batch") -> IdaState:
    """Place a batched IdaState with its leading axis sharded over ``axis``.

    Every leaf of the state has the batch as dim 0, so one PartitionSpec
    covers the whole pytree.
    """
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        return jax.device_put(x, sharding)

    return jax.tree_util.tree_map(put, states)


def make_mesh_2d(
    n_batch: int, n_state: int, axes=("batch", "state")
) -> Mesh:
    """A 2-D (batch x state) mesh: the DP-x-TP composition of SURVEY.md
    §2.2 — ensemble lanes split over one axis, each lane's state vector
    over the other."""
    devs = np.asarray(jax.devices()[: n_batch * n_state]).reshape(
        n_batch, n_state
    )
    return Mesh(devs, axes)


# IdaState fields that carry the system-size (N) axis — last axis in the
# single-instance layout, second-to-last in the batch-native layout (lu
# carries it twice: [N, N] / [N, N, B]). An EXPLICIT list, not a
# shape == n heuristic: for systems where N collides with another lane
# size (N == MXORDP1 == 6 would match psi/alpha/..., N == nroots would
# match iroots/gactive), a shape test mis-shards coefficient or root
# lanes over the state axis and forces resharding collectives into the
# supposedly collective-free inner loop.
_N_AXIS_FIELDS = frozenset({
    "phi", "ee", "yy", "yp", "yypredict", "yppredict", "ewt", "savres",
    "constraints", "piv", "lu",
})


def shard_ensemble_2d(
    states: IdaState,
    mesh: Mesh,
    n: int,
    batch_axis: str = "batch",
    state_axis: str = "state",
) -> IdaState:
    """Shard a BATCH-NATIVE (trailing-batch) ensemble state over a 2-D
    mesh: the trailing batch dim over ``batch_axis`` and, on the fields
    that carry it (``_N_AXIS_FIELDS``), the system-size dim over
    ``state_axis`` (phi [K, N, B] -> [K, N/s, B/b], ewt [N, B] ->
    [N/s, B/b], scalars-per-lane [B] -> [B/b]; problem-specific ``pdata``
    leaves shard on the batch axis only). Use with the matrix-free SPGMR
    path and a trailing-batch-aware residual, as in the heat2d model."""

    def put(x, with_state_axis):
        if x.ndim == 0:
            spec = P()
        else:
            dims = [None] * x.ndim
            dims[-1] = batch_axis
            if with_state_axis and x.ndim >= 2:
                dims[-2] = state_axis
            spec = P(*dims)
        return jax.device_put(x, NamedSharding(mesh, spec))

    out = {}
    for name, leaf in states._asdict().items():
        out[name] = jax.tree_util.tree_map(
            lambda x: put(x, name in _N_AXIS_FIELDS), leaf
        )
    return states._replace(**out)


def shard_state_vector(states: IdaState, mesh: Mesh, n: int, axis: str = "batch") -> IdaState:
    """Shard a SINGLE large system's state vector over the mesh (the
    tensor-parallel analogue, SURVEY.md §2.2 item 2): the fields carrying
    the N axis (``_N_AXIS_FIELDS``) are split on their last dimension;
    scalars, coefficient rows, and root lanes are replicated (explicit
    field list — see the note above). Under jit, XLA GSPMD inserts the
    collectives (halo exchanges for stencil residuals, psums inside SPGMR
    reductions).

    Use with the matrix-free SPGMR path; the dense path's [N, N] Jacobian
    should stay on one device (it is elided under spgmr anyway)."""

    def put(x, with_n):
        if with_n and x.ndim >= 1:
            spec = P(*([None] * (x.ndim - 1) + [axis]))
        else:
            spec = P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    out = {}
    for name, leaf in states._asdict().items():
        out[name] = jax.tree_util.tree_map(
            lambda x: put(x, name in _N_AXIS_FIELDS), leaf
        )
    return states._replace(**out)
