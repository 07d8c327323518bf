"""A collection written by the reference opens in the port. The reference's
AppContext (JAX on the CPU, graph built) ingests 2,000 x 64 clustered rows
(bench.py's gen_clustered formula) per kind (u8 "auto", quaternary, f32)
through a transaction with metadata and deletes, then streams a few more upserts and a delete, and closes: its
snapshot holds the graph arrays, and the streamed ops stay in a durable
WAL. The port's AppContext (device "cpu") opens the same data dir, loads
the store and the graph and replays the WAL (its insertion wave links the
streamed rows). Its dense searches, filtered and unfiltered, give the
reference's ids where the reference's scores are untied, with scores
within rtol 1e-5, atol 1e-6; GET vector gives the same record. So do its
graph searches (``flat_serve_threshold`` and ``graph_filter_min`` set to
1,000, below the 2,010 rows: the unfiltered graph route and the
oversampled, post-filtered graph route of a 25% filter). The port then
writes its own snapshot, graph included, which answers identically after
a restart, and which the reference loads back with the port's answers,
graph answers included.

A sparse collection goes the same way: the reference writes 1,500 docs
(zipf dims over a 500-dim vocab, 16 pairs each) through a transaction
with deletes, streams a few more and a delete; the port opens it, answers
its sparse searches (scores rtol 1e-5, atol 1e-6; ids where untied) and
GETs as the reference does, writes its own sparse snapshot (the
reference's layout), answers identically after a restart, and the
reference loads that snapshot back with the port's answers. A tf-idf
collection (1,500 zipf texts) goes the same way through ``tfidf.msgpack``.

A scan-only snapshot (an index with no graph, as earlier versions of the
port wrote them) is served at any size: the port's snapshot of 2,010 rows
with 30 deletes, rewritten without its graph and loaded by each package
with the limits set to 1,000, answers masked and unmasked searches in both;
the port's lists are those it gives under the limits, hold no deleted id,
and equal the reference's wherever the reference's lists hold no
tombstoned row (the reference serves tombstoned rows from a scan-only
snapshot: its loader replaces ``alive`` by a (1,) dummy that
``search_brute_device`` broadcasts, and its result formatting then drops
them, so its lists there are the port's less some entries, in the same
order). A freshly built index above the limits answers by its graph,
and a compaction rebuilds the graph."""

import numpy as np
import pytest
import torch

from cosdata_tpu.config import load_config as j_load_config
from cosdata_tpu.core.app_context import AppContext as JAppContext
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.config import load_config as t_load_config
from cosdata_tpu_torch.core.app_context import AppContext as TAppContext

torch.set_num_threads(1)
ADMIN = "snap-key"
DIM, N, NQ, K = 64, 2000, 8, 10
KINDS = {
    "u8": {"type": "auto", "sample_threshold": 100},
    "quaternary": {"type": "scalar", "data_type": "quaternary"},
    "f32": {"type": "scalar", "data_type": "f32"},
}
SCHEMA = {"fields": [{"name": "color", "values": ["red", "blue"]}], "supported_conditions": []}
RED = {"Is": {"field_name": "color", "field_value": "red", "operator": "Equal"}}
PROBE_IDS = [8, 9, 41, N + 2]
N_SP = 1500
SP_PROBES = [8, 9, 41, N_SP + 2]


def sparse_corpus(n, seed=7):
    rng = np.random.default_rng(seed)
    dims = (rng.pareto(1.2, size=(n, 16)) * 15).astype(np.int64) % 500
    vals = rng.gamma(2.0, 0.8, size=(n, 16)).astype(np.float32)
    return dims, vals


def _sparse_vec(i, dims, vals):
    return {"id": i, "sparse_values": [[int(d), float(v)] for d, v in zip(dims[i], vals[i])]}


def text_corpus(n, seed=11):
    words = np.random.default_rng(seed).pareto(1.1, size=(n, 20)).astype(np.int64) % 600
    return [" ".join(f"w{w}" for w in row) for row in words], words


def _text_queries():
    _, words = text_corpus(N_SP + 10)
    return [" ".join(f"w{w}" for w in np.sort(words[i])[-4:]) for i in range(0, 160, 10)]


def _sparse_queries(dims, vals):
    return [[(int(d), float(v)) for d, v in sorted(zip(dims[i], vals[i]))[-6:]] for i in range(0, 160, 10)]


def gen_clustered(n, nq, seed=0):
    """bench.py's gen_clustered formula (copied, without its file cache)."""
    rng = np.random.default_rng(seed)
    n_clusters = max(n // 100, 16)
    centers = rng.standard_normal(size=(n_clusters, DIM), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    noise = np.float32(0.5 / np.sqrt(DIM))

    def rows(m):
        x = rng.standard_normal(size=(m, DIM), dtype=np.float32) * noise
        x += centers[rng.integers(0, n_clusters, m)]
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    return rows(n), rows(nq)


def _vec(i, x):
    v = {"id": i, "dense_values": x[i].tolist()}
    if i % 2 == 0:
        v["metadata"] = {"color": "red" if i % 4 == 0 else "blue"}
    return v


def _answers(ctx, q):
    out = {}
    for name in KINDS:
        coll = ctx.get_collection(name)
        out[name] = {
            "plain": coll.search_dense(q, K),
            "filtered": coll.search_dense(q, K, filter_dto=RED),
            "vectors": [coll.get_vector(i) for i in PROBE_IDS],
        }
    coll = ctx.get_collection("sparse")
    out["sparse"] = {
        "search": coll.search_sparse(_sparse_queries(*sparse_corpus(N_SP + 10)), K),
        "vectors": [coll.get_vector(i) for i in SP_PROBES],
    }
    coll = ctx.get_collection("text")
    out["text"] = {
        "search": coll.search_tfidf(_text_queries(), K),
        "vectors": [coll.get_vector(i) for i in SP_PROBES],
    }
    return out


def _limited_answers(ctx, q, scan_only: bool):
    """Dense answers with the serving limits below the 2,010 rows: the
    graph's, or the scan's for an index with no graph."""
    out = {}
    for name in KINDS:
        d = ctx.get_collection(name).dense
        limits = d.flat_serve_threshold, d.graph_filter_min
        d.flat_serve_threshold = d.graph_filter_min = 1000
        assert d.index.scan_only == scan_only
        coll = ctx.get_collection(name)
        out[name] = {"plain": coll.search_dense(q, K), "filtered": coll.search_dense(q, K, filter_dto=RED)}
        d.flat_serve_threshold, d.graph_filter_min = limits
    return out


def _scan_only_answers(ctx, q):
    return _limited_answers(ctx, q, scan_only=True)


def _graph_answers(ctx, q):
    return _limited_answers(ctx, q, scan_only=False)


def _reference_writes(data_dir, x, q):
    ctx = JAppContext(j_load_config(data_path=str(data_dir)), admin_key=ADMIN)
    for name, quant in KINDS.items():
        coll = ctx.create_collection({
            "name": name, "dense_vector": {"enabled": True, "dimension": DIM},
            "metadata_schema": SCHEMA,
        })
        coll.create_dense_index(quantization=quant)
        txn = coll.create_transaction()
        coll.txn_upsert(txn.txn_id, [_vec(i, x) for i in range(N)], True)
        for i in range(3, 90, 3):
            coll.txn_delete(txn.txn_id, i)
        coll.index_version(coll.commit_transaction(txn.txn_id), txn)
        coll.stream_upsert([_vec(i, x) for i in range(N, N + 10)])
        coll.stream_delete(41)
    graph = _graph_answers(ctx, q)  # the snapshot holds the graph
    dims, vals = sparse_corpus(N_SP + 10)
    coll = ctx.create_collection({"name": "sparse", "sparse_vector": {"enabled": True}})
    coll.create_sparse_index(quantization=64, sample_threshold=300)
    txn = coll.create_transaction()
    coll.txn_upsert(txn.txn_id, [_sparse_vec(i, dims, vals) for i in range(N_SP)], True)
    for i in range(3, 90, 3):
        coll.txn_delete(txn.txn_id, i)
    coll.index_version(coll.commit_transaction(txn.txn_id), txn)
    coll.stream_upsert([_sparse_vec(i, dims, vals) for i in range(N_SP, N_SP + 10)])
    coll.stream_delete(41)
    texts, _ = text_corpus(N_SP + 10)
    coll = ctx.create_collection({"name": "text", "tf_idf_options": {"enabled": True}})
    coll.create_tf_idf_index(sample_threshold=300)
    txn = coll.create_transaction()
    coll.txn_upsert(txn.txn_id, [{"id": i, "text": texts[i]} for i in range(N_SP)], True)
    for i in range(3, 90, 3):
        coll.txn_delete(txn.txn_id, i)
    coll.index_version(coll.commit_transaction(txn.txn_id), txn)
    coll.stream_upsert([{"id": i, "text": texts[i]} for i in range(N_SP, N_SP + 10)])
    coll.stream_delete(41)
    answers = _answers(ctx, q)
    answers["graph"] = graph
    ctx.indexing.stop()
    ctx.meta.close()
    return answers


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    data_dir = tmp_path_factory.mktemp("data")
    x, q = gen_clustered(N + 10, NQ)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)  # the reference ships exact f32 rows and queries
        ref = _reference_writes(data_dir, x, q)
        snap = {name: data_dir / "collections" / name / "snapshot" for name in (*KINDS, "sparse", "text")}
        graph_before = {name: (p / "adj0.meta.json").exists() for name, p in snap.items()}
        wals_before = {name: len(list(p.parent.glob("*.wal"))) for name, p in snap.items()}
        port_ctx = TAppContext(t_load_config(data_path=str(data_dir)), admin_key=ADMIN, device="cpu")
        port = _answers(port_ctx, q)
        port["graph"] = _graph_answers(port_ctx, q)
        wals_after = {name: len(list(p.parent.glob("*.wal"))) for name, p in snap.items()}
        graph_after = {name: (p / "adj0.meta.json").exists() for name, p in snap.items()}
        port_ctx.close()
        back_ctx = JAppContext(j_load_config(data_path=str(data_dir)), admin_key=ADMIN)
        back = _answers(back_ctx, q)
        back["graph"] = _graph_answers(back_ctx, q)
        back_ctx.indexing.stop()
        back_ctx.meta.close()
        restart_ctx = TAppContext(t_load_config(data_path=str(data_dir)), admin_key=ADMIN, device="cpu")
        restart = _answers(restart_ctx, q)
        restart["graph"] = _graph_answers(restart_ctx, q)
        # rewrite the dense snapshots without their graphs
        for name in KINDS:
            coll = restart_ctx.get_collection(name)
            coll.dense.index.scan_only = True
            coll.save_snapshot()
        restart_ctx.close()
        scan_ctx = TAppContext(t_load_config(data_path=str(data_dir)), admin_key=ADMIN, device="cpu")
        restart_scan = _scan_only_answers(scan_ctx, q)
        scan_ctx.close()
        back_scan_ctx = JAppContext(j_load_config(data_path=str(data_dir)), admin_key=ADMIN)
        back_scan = _scan_only_answers(back_scan_ctx, q)
        back_scan_ctx.indexing.stop()
        back_scan_ctx.meta.close()
    return {
        "ref": ref, "port": port, "restart": restart, "back": back,
        "restart_scan": restart_scan, "back_scan": back_scan,
        "files": (graph_before, wals_before, wals_after, graph_after),
    }


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    gap = s[:-1] - s[1:]
    return (np.concatenate([[np.inf], gap]) > tol) & (np.concatenate([gap, [np.inf]]) > tol)


def _same_results(t, j):
    assert len(t) == len(j)
    for t_row, j_row in zip(t, j):
        assert len(t_row) == len(j_row) == K
        js = [r["score"] for r in j_row]
        np.testing.assert_allclose([r["score"] for r in t_row], js, rtol=1e-5, atol=1e-6)
        u = _untied(js)
        assert u.mean() > 0.5
        assert [r["id"] for r, ok in zip(t_row, u) if ok] == [r["id"] for r, ok in zip(j_row, u) if ok]


@pytest.mark.parametrize("kind", list(KINDS))
def test_search_matches_reference(runs, kind):
    _same_results(runs["port"][kind]["plain"], runs["ref"][kind]["plain"])


@pytest.mark.parametrize("kind", list(KINDS))
def test_filtered_search_matches_reference(runs, kind):
    t, j = runs["port"][kind]["filtered"], runs["ref"][kind]["filtered"]
    _same_results(t, j)
    assert all(r["id"] % 4 == 0 for row in t for r in row)


@pytest.mark.parametrize("kind", list(KINDS))
def test_get_vector_matches_reference(runs, kind):
    t, j = runs["port"][kind]["vectors"], runs["ref"][kind]["vectors"]
    assert t == j
    assert j[2] is None and len(j[3]["dense_values"]) == DIM  # 41 deleted, N + 2 streamed


@pytest.mark.parametrize("kind", list(KINDS))
def test_port_snapshot_round_trip(runs, kind):
    """The port replayed the streamed WAL, wrote its own snapshot (graph
    files included), and a restarted port answers identically, by the
    scan and by the graph."""
    graph_before, wals_before, wals_after, graph_after = runs["files"]
    assert graph_before[kind] and graph_after[kind]
    assert (wals_before[kind], wals_after[kind]) == (1, 0)
    assert runs["restart"][kind] == runs["port"][kind]
    assert runs["restart"]["graph"][kind] == runs["port"]["graph"][kind]


@pytest.mark.parametrize("mode", ["plain", "filtered"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_graph_snapshot_answers_in_port(runs, kind, mode):
    """The reference's graph, loaded by the port, answers as the reference's
    did (ids where untied); the filtered lists hold only red rows."""
    t, j = runs["port"]["graph"][kind][mode], runs["ref"]["graph"][kind][mode]
    _same_results(t, j)
    if mode == "filtered":
        assert all(r["id"] % 4 == 0 for row in t for r in row)


@pytest.mark.parametrize("mode", ["plain", "filtered"])
@pytest.mark.parametrize("kind", list(KINDS))
def test_port_graph_snapshot_answers_in_reference(runs, kind, mode):
    """The port's graph snapshot, loaded by the reference, answers as the
    port did; no deleted id comes back from either."""
    t, j = runs["port"]["graph"][kind][mode], runs["back"]["graph"][kind][mode]
    _same_results(t, j)
    dead = {41, *range(3, 90, 3)}
    assert not dead & {r["id"] for row in t for r in row}


def _in_order_subset(j_rows, t_rows):
    for j_row, t_row in zip(j_rows, t_rows):
        t_scores = {r["id"]: r["score"] for r in t_row}
        assert len(j_row) >= K // 2 and all(r["id"] in t_scores for r in j_row)
        assert [r["id"] for r in t_row if r["id"] in {s["id"] for s in j_row}] == [r["id"] for r in j_row]
        np.testing.assert_allclose([r["score"] for r in j_row], [t_scores[r["id"]] for r in j_row],
                                   rtol=1e-5, atol=1e-6)


def test_sparse_search_matches_reference(runs):
    _same_results(runs["port"]["sparse"]["search"], runs["ref"]["sparse"]["search"])
    dead = {41, *range(3, 90, 3)}
    assert not dead & {r["id"] for row in runs["port"]["sparse"]["search"] for r in row}


def test_sparse_get_vector_matches_reference(runs):
    t, j = runs["port"]["sparse"]["vectors"], runs["ref"]["sparse"]["vectors"]
    assert t == j
    assert j[2] is None and len(j[3]["sparse_values"]) == 16  # 41 deleted, N_SP + 2 streamed


def test_port_sparse_snapshot_round_trip(runs):
    """The port replayed the streamed WAL, wrote its own sparse snapshot in
    the reference's layout, and a restarted port answers identically."""
    _, wals_before, wals_after, _ = runs["files"]
    assert (wals_before["sparse"], wals_after["sparse"]) == (1, 0)
    assert runs["restart"]["sparse"] == runs["port"]["sparse"]


def test_reference_loads_port_sparse_snapshot(runs):
    back, port = runs["back"]["sparse"], runs["port"]["sparse"]
    _same_results(back["search"], port["search"])
    assert back["vectors"] == port["vectors"]


@pytest.mark.parametrize("kind", list(KINDS))
def test_reference_loads_port_snapshot(runs, kind):
    """The port's snapshot carries its tombstones (it holds a graph), so the
    reference's scan answers equal the port's."""
    back, port = runs["back"][kind], runs["port"][kind]
    _same_results(back["plain"], port["plain"])
    _same_results(back["filtered"], port["filtered"])
    assert back["vectors"] == port["vectors"]


def _same_text_results(t, j):
    assert len(t) == len(j)
    for t_row, j_row in zip(t, j):
        assert len(t_row) == len(j_row) > 0
        js = [r["score"] for r in j_row]
        np.testing.assert_allclose([r["score"] for r in t_row], js, rtol=1e-5, atol=1e-6)
        u = _untied(js)
        assert [r["id"] for r, ok in zip(t_row, u) if ok] == [r["id"] for r, ok in zip(j_row, u) if ok]


def test_text_search_matches_reference(runs):
    """A reference-written tfidf.msgpack (plus a streamed WAL) opens in the port."""
    _same_text_results(runs["port"]["text"]["search"], runs["ref"]["text"]["search"])
    dead = {41, *range(3, 90, 3)}
    assert not dead & {r["id"] for row in runs["port"]["text"]["search"] for r in row}
    t, j = runs["port"]["text"]["vectors"], runs["ref"]["text"]["vectors"]
    assert t == j and j[2] is None and j[3]["text"] == text_corpus(N_SP + 10)[0][N_SP + 2]


def test_port_text_snapshot_round_trip(runs):
    _, wals_before, wals_after, _ = runs["files"]
    assert (wals_before["text"], wals_after["text"]) == (1, 0)
    assert runs["restart"]["text"] == runs["port"]["text"]


def test_reference_loads_port_text_snapshot(runs):
    back, port = runs["back"]["text"], runs["port"]["text"]
    _same_text_results(back["search"], port["search"])
    assert back["vectors"] == port["vectors"]


@pytest.mark.parametrize("kind", list(KINDS))
def test_scan_only_snapshot_served_above_threshold(runs, kind):
    dead = {41, *range(3, 90, 3)}
    for mode in ("plain", "filtered"):
        port, ref = runs["restart_scan"][kind][mode], runs["back_scan"][kind][mode]
        assert port == runs["restart"][kind][mode]
        assert all(len(row) == K and not dead & {r["id"] for r in row} for row in port)
        full = [(t_row, j_row) for t_row, j_row in zip(port, ref) if len(j_row) == K]
        assert full
        _same_results([t for t, _ in full], [j for _, j in full])
        _in_order_subset(ref, port)


def test_fresh_index_above_threshold_needs_the_graph():
    """A freshly built index above the limits answers by its graph: the
    unfiltered route and the oversampled, post-filtered route of a
    permissive filter; a compaction rebuilds the graph. An index with no
    graph (scan-only) takes the scan at any size."""
    from cosdata_tpu_torch.core.collection import DenseIndexHandle

    x, q = gen_clustered(300, 4)
    truth = np.argsort(-(q @ x.T), axis=1)[:, :K]
    d = DenseIndexHandle(DIM, "cpu", quantization={"type": "scalar", "data_type": "u8"})
    d.add_batch(list(range(300)), x)
    assert not d.index.scan_only and d.index.entry >= 0
    want = d.search(q, K)
    np.testing.assert_array_equal(want[0], truth)  # the exact scan under the limits
    d.flat_serve_threshold = d.graph_filter_min = 100
    ids, _ = d.search(q, K)
    assert np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)]) >= 0.9
    mask = np.arange(300) % 2 == 0
    ids, _ = d.search(q, K, row_mask=mask)
    assert (ids >= 0).all() and (ids % 2 == 0).all()
    for i in range(0, 300, 3):
        d.delete(i)
    d.flush()
    assert d.index.n == 200 and not d.index.scan_only and d.index.n_deleted == 0
    ids, _ = d.search(q, K, row_mask=np.ones(200, bool))
    assert (ids >= 0).all() and not (ids % 3 == 0).any()
    live = [i for i in range(300) if i % 3]
    truth_live = np.asarray(live)[np.argsort(-(q @ x[live].T), axis=1)[:, :K]]
    ids, _ = d.search(q, K)
    assert np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth_live)]) >= 0.9
    d.index.scan_only = True
    ids, _ = d.search(q, K)
    np.testing.assert_array_equal(ids, truth_live)


# ---------------------------------------------------------------- euclidean and hamming

METRICS = ("euclidean", "hamming")
DEAD = {41, *range(3, 90, 3)}


def _metric_rows():
    """gen_clustered rows scaled to norms 0.5-1.5, so euclidean ranks
    unlike cosine."""
    x, q = gen_clustered(N + 10, NQ, seed=4)
    return (x * np.random.default_rng(5).uniform(0.5, 1.5, (N + 10, 1))).astype(np.float32), q


def _metric_answers(ctx, q):
    out = {}
    for metric in METRICS:
        coll = ctx.get_collection(f"m_{metric}")
        out[metric] = {"plain": coll.search_dense(q, K), "filtered": coll.search_dense(q, K, filter_dto=RED),
                       "deep_plain": coll.search_dense(q, 2 * K),
                       "deep_filtered": coll.search_dense(q, 2 * K, filter_dto=RED),
                       "vectors": [coll.get_vector(i) for i in PROBE_IDS]}
    return out


@pytest.fixture(scope="module")
def metric_runs(tmp_path_factory):
    """Euclidean and hamming collections written by the reference (a
    transaction with deletes, streamed upserts and a delete), opened by the
    port, snapshotted by it and reopened by each package."""
    data_dir = tmp_path_factory.mktemp("metrics")
    x, q = _metric_rows()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        ctx = JAppContext(j_load_config(data_path=str(data_dir)), admin_key=ADMIN)
        for metric in METRICS:
            coll = ctx.create_collection({"name": f"m_{metric}", "dense_vector": {"enabled": True, "dimension": DIM},
                                          "metadata_schema": SCHEMA})
            coll.create_dense_index(distance_metric=metric, quantization={"type": "auto", "sample_threshold": 100})
            txn = coll.create_transaction()
            coll.txn_upsert(txn.txn_id, [_vec(i, x) for i in range(N)], True)
            for i in range(3, 90, 3):
                coll.txn_delete(txn.txn_id, i)
            coll.index_version(coll.commit_transaction(txn.txn_id), txn)
            coll.stream_upsert([_vec(i, x) for i in range(N, N + 10)])
            coll.stream_delete(41)
        ref = _metric_answers(ctx, q)
        scan_only = {m: ctx.get_collection(f"m_{m}").dense.index.scan_only for m in METRICS}
        ctx.indexing.stop()
        ctx.meta.close()
        port_ctx = TAppContext(t_load_config(data_path=str(data_dir)), admin_key=ADMIN, device="cpu")
        port = _metric_answers(port_ctx, q)
        port_scan_only = {m: port_ctx.get_collection(f"m_{m}").dense.index.scan_only for m in METRICS}
        port_ctx.close()
        restart_ctx = TAppContext(t_load_config(data_path=str(data_dir)), admin_key=ADMIN, device="cpu")
        restart = _metric_answers(restart_ctx, q)
        restart_ctx.close()
        back_ctx = JAppContext(j_load_config(data_path=str(data_dir)), admin_key=ADMIN)
        back = _metric_answers(back_ctx, q)
        back_ctx.indexing.stop()
        back_ctx.meta.close()
    return {"ref": ref, "port": port, "restart": restart, "back": back,
            "scan_only": (scan_only, port_scan_only)}


@pytest.mark.parametrize("metric", METRICS)
def test_metric_snapshot_opens_in_port(metric_runs, metric):
    """The reference's snapshot (and WAL) of a euclidean collection, with its
    graph, and of a hamming collection, scan-only in both packages, answer
    in the port as the reference answered before closing."""
    ref, port = metric_runs["ref"][metric], metric_runs["port"][metric]
    scan_only, port_scan_only = metric_runs["scan_only"]
    assert scan_only[metric] == port_scan_only[metric] == (metric == "hamming")
    for mode in ("plain", "filtered"):
        _same_results(port[mode], ref[mode])
        assert not DEAD & {r["id"] for row in port[mode] for r in row}
    assert port["vectors"] == ref["vectors"]


@pytest.mark.parametrize("metric", METRICS)
def test_metric_snapshot_round_trip(metric_runs, metric):
    """The port's own snapshot answers identically after a restart, and a
    deleted row never comes back."""
    port, restart = metric_runs["port"][metric], metric_runs["restart"][metric]
    assert restart == port
    assert all(len(row) == K and not DEAD & {r["id"] for r in row} for row in restart["plain"])


@pytest.mark.parametrize("metric", METRICS)
def test_reference_loads_port_metric_snapshot(metric_runs, metric):
    """The reference opens the port's snapshot. Euclidean answers as the
    port does; the hamming snapshot is scan-only and the reference's loader
    drops its tombstones (ROADMAP queue 3), so the reference serves
    deleted rows that its result formatting then drops. A dead row also
    takes a slot of the reference's 50-row hamming shortlist, so a live row
    that the port reranks into its top 10 may be missing there: the
    reference's lists are in-order subsets of the port's top 20, and the
    port's hold no deleted row."""
    back, port = metric_runs["back"][metric], metric_runs["port"][metric]
    for mode in ("plain", "filtered"):
        if metric == "euclidean":
            _same_results(back[mode], port[mode])
        else:
            _in_order_subset(back[mode], port[f"deep_{mode}"])
            assert not DEAD & {r["id"] for row in port[f"deep_{mode}"] for r in row}
    assert back["vectors"] == port["vectors"]
