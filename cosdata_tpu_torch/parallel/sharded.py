"""Sharded dense scoring and top-k over a device mesh (port of
cosdata_tpu/parallel/sharded.py).

- A :class:`Mesh` is a dp x tp grid of devices. Vectors (N, D) are split
  N over dp and D over tp: the store is a grid of f32 blocks
  (N/dp, D/tp), one per mesh device, and each dp row keeps its rows'
  magnitudes on its first device.
- Queries are replicated over dp and split D over tp. Each device forms
  its partial product; the tp partials of a dp row are summed on that
  row's first device, in tp order (the reference's ``psum`` over "tp");
  each dp row takes its own top-k, and the dp rows' lists are
  concatenated on the first mesh device (its ``all_gather`` over "dp")
  for the final top-k.
- Inserts write each wave only into the row slice a dp row owns.

One process owns every device of the mesh and serves the index, as the
reference's single controller does; no ``torch.distributed`` process
group is involved. Devices may repeat in a mesh (four blocks on one card),
which stands in for the reference tests' virtual CPU devices. The partial
products are ``torch.matmul`` in exact f32 (TF32 off), as the reference's
are XLA ``dot_general`` outside any Pallas kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from cosdata_tpu_torch.ops.distance import _no_tf32, sqrt_rn
from cosdata_tpu_torch.ops.topk import NEG_INF, lax_top_k


class Mesh:
    """A dp x tp grid of torch devices (``devices[i][j]``: dp row i, tp
    column j)."""

    def __init__(self, devices: list[list[torch.device]]):
        self.devices = [[torch.device(d) for d in row] for row in devices]
        self.shape = {"dp": len(self.devices), "tp": len(self.devices[0])}


def make_mesh(n_devices: int | None = None, tp: int | None = None, devices: list | None = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA device; a list
    may repeat a device), the first ``n_devices`` of them if given. ``tp``
    defaults to 2 when the count is even and at least 4, else 1; dp is
    count // tp."""
    devs = list(devices) if devices is not None else [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())
    ]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if tp is None:
        tp = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // tp
    if dp < 1:
        raise ValueError(f"mesh needs at least tp={tp} devices, found {n} ({devs}); pass devices explicitly")
    return Mesh([devs[i * tp : (i + 1) * tp] for i in range(dp)])


def _norms(x: torch.Tensor) -> torch.Tensor:
    return sqrt_rn((x * x).sum(-1))


def shard_vectors(mesh: Mesh, vectors, mags=None):
    """Place (N, D) f32 vectors on the mesh; N must divide by dp and D by
    tp. Returns (blocks [dp][tp] of (N/dp, D/tp), mags [dp] of (N/dp,))."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    v = torch.as_tensor(vectors, dtype=torch.float32)
    n, d = v.shape
    if n % dp or d % tp:
        raise ValueError(f"({n}, {d}) does not divide over dp={dp}, tp={tp}")
    m = _norms(v) if mags is None else torch.as_tensor(mags, dtype=torch.float32, device=v.device)
    nl, dl = n // dp, d // tp
    blocks = [[v[i * nl : (i + 1) * nl, j * dl : (j + 1) * dl].to(dev, copy=True) for j, dev in enumerate(row)]
              for i, row in enumerate(mesh.devices)]
    mag_blocks = [m[i * nl : (i + 1) * nl].to(row[0], copy=True) for i, row in enumerate(mesh.devices)]
    return blocks, mag_blocks


def sharded_search(mesh: Mesh, vectors, mags, queries, q_mags, n_valid: int, k: int, metric: str = "cosine"):
    """(B, k) global top-k of the sharded exact scores, on the first mesh
    device: (values, global row ids), ids -1 for unfilled slots. Rows at or
    past ``n_valid`` never answer."""
    _no_tf32()
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    queries = torch.as_tensor(queries, dtype=torch.float32)
    dl = queries.shape[1] // tp
    # every device's partial product is issued before any is summed
    parts = [[queries[:, j * dl : (j + 1) * dl].to(vectors[i][j].device) @ vectors[i][j].T for j in range(tp)]
             for i in range(dp)]
    out_dev = mesh.devices[0][0]
    vals_all, gids_all = [], []
    for i in range(dp):
        home = mesh.devices[i][0]
        dots = parts[i][0]
        for j in range(1, tp):  # the psum over "tp", in tp order
            dots = dots + parts[i][j].to(home)
        m = mags[i]
        qm = torch.as_tensor(q_mags, dtype=torch.float32).to(home)
        if metric == "cosine":
            den = qm[:, None] * m[None, :]
            scores = torch.where(den > 1e-30, dots / torch.clamp_min(den, 1e-30), 0.0)
        elif metric == "dot":
            scores = dots
        else:  # euclidean
            scores = -sqrt_rn(torch.clamp_min(qm[:, None] * qm[:, None] + m[None, :] * m[None, :] - 2 * dots, 0.0))
        nloc = scores.shape[1]
        base = i * nloc
        row_ids = base + torch.arange(nloc, device=home)
        scores = torch.where(row_ids[None, :] < n_valid, scores, NEG_INF)
        vals, idx = torch.topk(scores, min(k, nloc), dim=1)
        vals_all.append(vals.to(out_dev))
        gids_all.append((base + idx).to(out_dev))
    # the all_gather over "dp" and the final merge
    all_vals = torch.cat(vals_all, dim=1)
    all_gids = torch.cat(gids_all, dim=1)
    top_vals, pos = lax_top_k(all_vals, k)
    top_gids = torch.gather(all_gids, 1, pos)
    top_gids = torch.where(top_vals > -1.0e38, top_gids, -1)
    return top_vals, top_gids


def sharded_insert(mesh: Mesh, vectors, mags, new_rows, new_mags, offset: int):
    """Write a wave of rows (W, D) at global rows [offset, offset + W) into
    the sharded store, in place: each dp row writes only the rows of its
    own slice and drops the rest. Returns (vectors, mags)."""
    dp, tp = mesh.shape["dp"], mesh.shape["tp"]
    new_rows = torch.as_tensor(new_rows, dtype=torch.float32)
    new_mags = torch.as_tensor(new_mags, dtype=torch.float32)
    dl = new_rows.shape[1] // tp
    for i in range(dp):
        nloc = vectors[i][0].shape[0]
        base = i * nloc
        lo, hi = max(offset, base), min(offset + new_rows.shape[0], base + nloc)
        if lo >= hi:
            continue
        src, dst = slice(lo - offset, hi - offset), slice(lo - base, hi - base)
        for j in range(tp):
            blk = vectors[i][j]
            blk[dst] = new_rows[src, j * dl : (j + 1) * dl].to(blk.device)
        mags[i][dst] = new_mags[src].to(mags[i].device)
    return vectors, mags


class ShardedFlatIndex:
    """Data-parallel flat index over a mesh: rows sharded, queries
    replicated, top-k lists merged."""

    def __init__(self, mesh: Mesh, dim: int, capacity: int, metric: str = "cosine"):
        self.mesh = mesh
        self.metric = metric
        self.dim = dim
        dp, tp = mesh.shape["dp"], mesh.shape["tp"]
        if capacity % dp:
            capacity = -(-capacity // dp) * dp
        if dim % tp:
            raise ValueError(f"dim {dim} must divide tp={tp}")
        self.capacity = capacity
        self.n = 0
        nl, dl = capacity // dp, dim // tp
        self.vectors = [[torch.zeros((nl, dl), dtype=torch.float32, device=dev) for dev in row]
                        for row in mesh.devices]
        self.mags = [torch.zeros((nl,), dtype=torch.float32, device=row[0]) for row in mesh.devices]

    def add(self, x) -> np.ndarray:
        """Append (B, dim) rows (numpy, list or tensor); returns their ids."""
        w = torch.as_tensor(x, dtype=torch.float32)
        if w.ndim == 1:
            w = w[None]
        if self.n + len(w) > self.capacity:
            raise RuntimeError("sharded store is fixed-capacity; presize it")
        self.vectors, self.mags = sharded_insert(self.mesh, self.vectors, self.mags, w, _norms(w), self.n)
        ids = np.arange(self.n, self.n + len(w), dtype=np.int64)
        self.n += len(w)
        return ids

    def search(self, queries, top_k: int = 10):
        """Host (ids (B, k), scores (B, k)); -1 for unfilled slots."""
        q = torch.as_tensor(queries, dtype=torch.float32)
        if q.ndim == 1:
            q = q[None]
        vals, gids = sharded_search(self.mesh, self.vectors, self.mags, q, _norms(q), self.n, top_k, self.metric)
        return gids.cpu().numpy().astype(np.int64), vals.cpu().numpy()
