"""Port parity: the chunked scan (``flat_scan_topk``) and ``fused_flat_search``
over sub-byte (res 1/2/3), f16 and f32 stores, against the reference on the
same numpy inputs.

Sub-byte scan scores tie heavily (the code dots are small integers), and
``torch.topk`` orders ties differently from ``lax.top_k``. So: without the
rerank, the sorted scores agree within rtol 1e-5 and the ids wherever the
reference's scores are untied; with it, the exact scores agree within rtol
1e-5, the ids where untied, and recall@10 against the exact f32 oracle is
at least the reference's."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cosdata_tpu.ops import flat_scan as JF
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.ops import flat_scan as TF
from cosdata_tpu_torch.ops import storage as TS

torch.set_num_threads(1)

D_TRUE, D_PAD, CAP, N, B = 100, 128, 16384, 15000, 16
K, K_FETCH, CHUNK = 10, 200, 4096
KINDS = {"binary": ("subbyte", 1), "quaternary": ("subbyte", 2), "octal": ("subbyte", 3),
         "f16": ("float", 2), "f32": ("float", 2)}


@pytest.fixture(autouse=True)
def fast_wire(monkeypatch):
    """The reference ships exact f32 queries, as the port does."""
    monkeypatch.setattr(JS, "_WIRE_BW_MBPS", 1e9)


def _clustered(n, d, nq, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((max(n // 100, 16), d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    noise = np.float32(0.5 / np.sqrt(d))

    def rows(m):
        x = rng.standard_normal((m, d)).astype(np.float32) * noise
        x += centers[rng.integers(0, len(centers), m)]
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return rows(n), rows(nq)


@pytest.fixture(scope="module")
def case():
    x, qx = _clustered(N, D_TRUE, B, seed=11)
    # per-dim spread ~0.5, so the [-1, 1] buckets carry information
    x, qx = x * np.float32(5.0), qx * np.float32(5.0)
    xp = np.zeros((CAP, D_PAD), np.float32)
    xp[:N, :D_TRUE] = x
    qp = np.zeros((B, D_PAD), np.float32)
    qp[:, :D_TRUE] = qx
    valid = np.zeros(CAP, bool)
    valid[:N] = True
    valid[[3, 40, 1000, 9000]] = False  # tombstones
    truth = {}
    for metric in ("cosine", "dot"):
        xs = x / np.linalg.norm(x, axis=1, keepdims=True) if metric == "cosine" else x
        s = qx @ xs.T
        s[:, ~valid[:N]] = -np.inf
        truth[metric] = np.argsort(-s, axis=1)[:, :K]
    return dict(xp=xp, qp=qp, valid=valid, truth=truth)


def _stores(c, name):
    kind, res = KINDS[name]
    skind = name if kind == "float" else "subbyte"
    j = JS._quantize_batch(jnp.asarray(c["xp"]), -1.0, 1.0, skind, res, D_TRUE)
    t = TS.quantize_batch(torch.from_numpy(c["xp"]), -1.0, 1.0, skind, res, D_TRUE)
    return kind, res, j, t


def _recall(ids, truth):
    return np.mean([len(set(a) & set(b)) / K for a, b in zip(np.asarray(ids), truth)])


def _untied(s, rtol=1e-5):
    """Positions whose score differs from both neighbours; the last column
    may tie with a row just outside the top-k, so it never counts."""
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    prev = np.full(s.shape, np.inf)
    prev[:, 1:] = s[:, :-1] - s[:, 1:]
    nxt = np.zeros(s.shape)
    nxt[:, :-1] = s[:, :-1] - s[:, 1:]
    return (prev > tol) & (nxt > tol)


def _compare(t_ids, t_vals, j_ids, j_vals, min_untied):
    j_ids, j_vals = np.asarray(j_ids), np.asarray(j_vals)
    t_ids, t_vals = t_ids.numpy(), t_vals.numpy()
    assert t_ids.shape == j_ids.shape and t_ids.dtype == np.int64
    np.testing.assert_allclose(t_vals, j_vals, rtol=1e-5, atol=1e-6)
    u = _untied(j_vals)
    assert u.mean() >= min_untied, u.mean()
    np.testing.assert_array_equal(t_ids[u], j_ids[u])


@pytest.mark.parametrize("name", list(KINDS))
def test_flat_scan_topk(case, name):
    c = case
    kind, res, j_store, t_store = _stores(c, name)
    # "float" queries are f32 rows over an f16 or f32 store
    j_q = JS._quantize_batch(jnp.asarray(c["qp"]), -1.0, 1.0, kind, res, D_TRUE)
    t_q = TS.quantize_batch(torch.from_numpy(c["qp"]), -1.0, 1.0, kind, res, D_TRUE)
    j_vals, j_ids = JF.flat_scan_topk(
        "cosine", kind, D_PAD, K_FETCH, CHUNK, j_q, j_store, jnp.asarray(c["valid"]), exact=True
    )
    t_vals, t_ids = TF.flat_scan_topk("cosine", kind, D_PAD, K_FETCH, CHUNK, t_q, t_store, torch.from_numpy(c["valid"]))
    _compare(t_ids, t_vals, j_ids, j_vals, min_untied=0.5 if kind == "float" else 0.0)
    assert c["valid"][t_ids.numpy()].all()


@pytest.mark.parametrize("rerank", [True, False])
@pytest.mark.parametrize("metric", ["cosine", "dot"])
@pytest.mark.parametrize("name", list(KINDS))
def test_fused_flat_search(case, name, metric, rerank):
    c = case
    kind, res, j_store, t_store = _stores(c, name)
    j_ids, j_vals = JF.fused_flat_search(
        metric, kind, D_TRUE, D_PAD, res, K_FETCH, K, CHUNK, rerank, jnp.asarray(c["qp"]),
        -1.0, 1.0, j_store, jnp.asarray(c["xp"]), jnp.asarray(c["valid"]),
    )
    t_ids, t_vals = TF.fused_flat_search(
        metric, kind, D_TRUE, D_PAD, res, K_FETCH, K, CHUNK, rerank, torch.from_numpy(c["qp"]),
        -1.0, 1.0, t_store, torch.from_numpy(c["xp"]) if rerank else None, torch.from_numpy(c["valid"]),
    )
    assert t_ids.shape == (B, K)
    exact = rerank or kind == "float"
    _compare(t_ids, t_vals, j_ids, j_vals, min_untied=0.5 if exact else 0.0)
    assert c["valid"][t_ids.numpy()].all()
    if rerank:
        rt, rj = _recall(t_ids, c["truth"][metric]), _recall(j_ids, c["truth"][metric])
        assert rt >= rj and rt >= 0.9, (rt, rj)
