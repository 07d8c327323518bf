"""Port parity of the HNSW index (cosdata_tpu_torch/indexes/hnsw.py) against
the reference's HNSWIndex at small sizes: 2,000 x 64 random unit rows (as
the reference's own tests draw them), the reference's test parameters
(tests/test_hnsw.py's SMALL), u8, quaternary, f16 and f32 stores by
cosine, and u8 and f32 stores by euclidean distance (on unit rows it ranks
as cosine does, so the same brute-force truth serves both).

What is held, per kind:

- the levels drawn (and the entry point) equal the reference's: both
  draw them from numpy's ``default_rng(seed)`` in the same order;
- the exact-path ``bulk_build`` (BULK_THRESHOLD lowered to 1,000 in both)
  agrees with the reference's graph on at least 99% of its adjacency
  entries, level 0 and the upper levels, compared as sets per row; so
  does the RP-tree path (RP_THRESHOLD and RP_LEAF lowered to 1,000 and
  512 in both, as the reference's own RP test does);
- a reference graph carried over by ``HNSWIndex.from_arrays`` answers with
  the reference's ids for every query whose scores are untied (rtol 1e-5),
  with scores within rtol 1e-5, atol 1e-6;
- insertion waves and ``refine`` reach a recall@10 against brute force no
  more than 0.01 below the reference's (the two beams see scores that
  differ in the last bits, so the graphs are not equal id for id);
- a tombstoned row never comes back.
"""

import numpy as np
import pytest
import torch

from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.indexes import hnsw as TH

torch.set_num_threads(1)

D, N, NQ, K = 64, 2000, 32, 10
SMALL = dict(num_layers=4, wave_size=256, ef_construction=64, ef_search=96, max_iters=64, visited_cap=1024)
#: name -> (storage kind, resolution, metric)
KINDS = {
    "u8": ("u8", 2, "cosine"), "quaternary": ("subbyte", 2, "cosine"), "f16": ("f16", 2, "cosine"),
    "f32": ("f32", 2, "cosine"), "u8-euclidean": ("u8", 2, "euclidean"), "f32-euclidean": ("f32", 2, "euclidean"),
}
RANGE = (-0.3, 0.3)


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def data():
    """Uniform rows: the u8 exact bulk path selects on bf16-rounded scores
    (the reference's shortlist), whose ties the reference orders
    arbitrarily; spread-out similarities keep such ties rare."""
    x, q = _unit(N, D, 17), _unit(NQ, D, 18)
    truth = np.argsort(-(q @ x.T), axis=1)[:, :K]
    return x, q, truth


def _pair(name, seed=3):
    kind, res, metric = KINDS[name]
    params = dict(SMALL)
    j = JH.HNSWIndex(D, metric=metric, kind=kind, resolution=res, range_=RANGE, params=JH.HNSWParams(**params),
                     seed=seed, initial_capacity=N, ship_dtype="f32")
    t = TH.HNSWIndex(D, "cpu", metric=metric, kind=name if kind == "subbyte" else kind, range_=RANGE,
                     params=TH.HNSWParams(**params), seed=seed, initial_capacity=N)
    return j, t


def _recall(ids, truth):
    return np.mean([len(set(a) & set(b)) / K for a, b in zip(np.asarray(ids), truth)])


def _graph_agreement(t, j):
    """Share of the reference's adjacency entries (level 0 and every upper
    level, compared as sets per row) that the port's graph holds."""
    hit = total = 0
    tables = [(t.adj0.numpy(), np.asarray(j.adj0))]
    ju = np.asarray(j.up_adj)
    for lvl in range(ju.shape[1]):
        tables.append((t.up_adj[:, lvl].numpy(), ju[:, lvl]))
    for ta, ja in tables:
        for g, w in zip(ta, ja):
            w = set(w[w >= 0].tolist())
            if w:
                hit += len(w & set(g[g >= 0].tolist()))
                total += len(w)
    return hit / max(total, 1)


def _same_state(t, j):
    np.testing.assert_array_equal(t.levels[: t.n], np.asarray(j.levels)[: j.n])
    np.testing.assert_array_equal(t.level_counts, j.level_counts)
    np.testing.assert_array_equal(t.up_slot_host[: t.n], j.up_slot_host[: j.n])
    assert (t.entry, t.entry_level, t.n_up) == (j.entry, j.entry_level, j.n_up)


@pytest.fixture(scope="module", params=list(KINDS))
def built(request, data):
    """Per kind, both packages' indexes: filled by insertion waves (two
    adds, recall read, then refined), and bulk-built on the exact path."""
    x, q, truth = data
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        j, t = _pair(request.param)
        for part in (x[:1200], x[1200:]):
            j.add(part)
            t.add(part)
        before = (_recall(t.search(q, K)[0], truth), _recall(j.search(q, K)[0], truth))
        j.refine()
        t.refine()
        waves = (j, t, before)
        mp.setattr(JH.HNSWIndex, "BULK_THRESHOLD", 1000)
        mp.setattr(TH.HNSWIndex, "BULK_THRESHOLD", 1000)
        j, t = _pair(request.param)
        j.add(x)
        t.add(x)
    return {"name": request.param, "waves": waves, "bulk": (j, t)}


def test_levels_match_reference(built):
    for j, t, *_ in (built["waves"], built["bulk"]):
        _same_state(t, j)


#: edge agreement of the exact-path bulk build with the reference's. The u8
#: exact path selects on bf16-rounded scores as the reference's shortlist
#: does; euclidean distances near 1.3 round to steps of 2^-7 there, so
#: ties are ~4x denser than cosine's, and the reference's approx_max_k
#: orders ties of long rows in its own sort order, not by index: 0.974 of
#: the edges agree on this draw, and the graphs' recall is held as well
BULK_AGREEMENT = {"u8-euclidean": 0.97}


def test_exact_bulk_build_matches_reference(data, built):
    _, q, truth = data
    j, t = built["bulk"]
    assert t.last_build_stats is not None
    assert _graph_agreement(t, j) >= BULK_AGREEMENT.get(built["name"], 0.99)
    rt, rj = _recall(t.search(q, K)[0], truth), _recall(j.search(q, K)[0], truth)
    assert rt >= rj - 0.01, (rt, rj)


@pytest.mark.parametrize("name", ["u8", "quaternary"])
def test_rp_bulk_build_matches_reference(data, name, monkeypatch):
    x, q, truth = data
    monkeypatch.setattr(JS, "_WIRE_BW_MBPS", 1e9)
    for cls in (JH.HNSWIndex, TH.HNSWIndex):
        monkeypatch.setattr(cls, "BULK_THRESHOLD", 1000)
        monkeypatch.setattr(cls, "RP_THRESHOLD", 1000)
        monkeypatch.setattr(cls, "RP_LEAF", 512)
    j, t = _pair(name, seed=9)
    j.add(x)
    t.add(x)
    _same_state(t, j)
    assert _graph_agreement(t, j) >= 0.99
    rt, rj = _recall(t.search(q, K)[0], truth), _recall(j.search(q, K)[0], truth)
    assert rt >= rj - 0.01, (rt, rj)


def test_waves_and_refine_recall(data, built):
    _, q, truth = data
    j, t, (rt0, rj0) = built["waves"]
    assert rt0 >= rj0 - 0.01, (rt0, rj0)
    rt, rj = _recall(t.search(q, K)[0], truth), _recall(j.search(q, K)[0], truth)
    assert rt >= rj - 0.01, (rt, rj)
    # the graphs grew from the same levels; most edges agree
    assert _graph_agreement(t, j) >= 0.8


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    gap = s[:, :-1] - s[:, 1:]
    inf = np.full((s.shape[0], 1), np.inf)
    return (np.concatenate([inf, gap], 1) > tol) & (np.concatenate([gap, inf], 1) > tol)


def _arrays_of(j) -> dict:
    a = {k: np.asarray(v) for k, v in j.store._arrays._asdict().items()}
    a.update(
        raw=np.asarray(j.store._raw), n=j.store.n, capacity=j.store.capacity, dim=D, range=j.store.range,
        adj0=np.asarray(j.adj0), adj0_d=np.asarray(j.adj0_d), up_adj=np.asarray(j.up_adj),
        up_d=np.asarray(j.up_d), up_slot=np.asarray(j.up_slot), levels=j.levels, level_counts=j.level_counts,
        n_up=j.n_up, entry=j.entry, entry_level=j.entry_level, alive=np.asarray(j.alive),
    )
    return a


def test_from_arrays_answers_like_reference(data, built):
    _, q, _ = data
    j, _ = built["bulk"]
    t = TH.HNSWIndex.from_arrays(_arrays_of(j), metric=KINDS[built["name"]][2], device="cpu",
                                 params=TH.HNSWParams(**SMALL))
    assert (t.store.kind, t.cap) == (j.store.kind, j.cap)
    for ef in (None, 64):
        j_ids, j_sc = j.search(q, K, ef=ef)
        t_ids, t_sc = t.search(q, K, ef=ef)
        same = (t_ids == j_ids).all(1)
        untied = _untied(j_sc).all(1)
        assert untied.mean() > 0.5
        assert same[untied].all(), np.flatnonzero(untied & ~same)
        np.testing.assert_allclose(t_sc[same], j_sc[same], rtol=1e-5, atol=1e-6)


def test_tombstones_never_return(data, built):
    x, _, _ = data
    for _, t, *_ in (built["waves"], built["bulk"]):
        probe = [5, 77, 1500]
        ids, _ = t.search(x[probe], K)
        assert ids[:, 0].tolist() == probe
        dead = [5, 77, 1500, *ids[:, 1].tolist()]
        for i in dead:
            t.delete(i)
        ids, _ = t.search(x[probe], K, ef=128)
        assert not np.isin(ids, dead).any() and (ids >= 0).all()
        for i in dead:  # the fixtures are shared: undo the tombstones
            t.alive[i] = True
        t.n_deleted -= len(dead)


def test_empty_and_small_semantics():
    t = TH.HNSWIndex(16, "cpu", kind="f32", params=TH.HNSWParams(**SMALL))
    ids, scores = t.search(np.zeros((2, 16), np.float32), top_k=3)
    assert (ids == -1).all() and np.isneginf(scores).all()
    x = _unit(300, 16, 2)
    t.add(x[:1])  # a single row is the entry
    t.add(x[1:])
    ids, _ = t.search(x[:8], top_k=1)
    assert (ids[:, 0] == np.arange(8)).all()
    with pytest.raises(RuntimeError, match="store is not spillable"):
        t.force_spill()  # an f32 store with device raw rows
