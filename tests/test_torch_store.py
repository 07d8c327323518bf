"""The port's copied store modules against the reference's on the CPU: the
WAL (same bytes for the same ops, each package reads the other's files),
VersionControl (the same sequence gives the same versions over one
MetaStore), chunked snapshots (a second save rewrites only the dirty
chunks; the port's snapshot loads back to the same answers) and flush-time
compaction (at 30% tombstones the store shrinks, and the answers, filtered
or not, stay the same; for 2-bit codes, whose shortlist ties break by row
position, every answer stays an exact rerank score and recall holds)."""

import numpy as np
import pytest
import torch

from cosdata_tpu.store import chunked as j_chunked
from cosdata_tpu.store import meta as j_meta
from cosdata_tpu.store import versioning as j_versioning
from cosdata_tpu.store import wal as j_wal
from cosdata_tpu_torch.core.collection import Collection, DenseIndexHandle
from cosdata_tpu_torch.metadata.filtering import compile_filter
from cosdata_tpu_torch.metadata.schema import MetadataSchema
from cosdata_tpu_torch.store import chunked as t_chunked
from cosdata_tpu_torch.store import meta as t_meta
from cosdata_tpu_torch.store import versioning as t_versioning
from cosdata_tpu_torch.store import wal as t_wal
from cosdata_tpu_torch.store.snapshots import load_collection_state

torch.set_num_threads(1)
DIM, K = 64, 10


def _unit(n, seed):
    x = np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


OPS = [
    ("upsert", [{"id": "a", "dense_values": [0.5, -0.25], "metadata": {"c": "x"}}, {"id": 7, "text": "t"}]),
    ("delete", "a"),
    ("upsert", [{"id": "b", "dense_values": [1.0, 2.0], "document_id": "d1"}]),
    ("delete", 7),
]


def _write(mod, path, durable):
    w = mod.DurableWALFile(path) if durable else mod.WALFile()
    for op, payload in OPS:
        (w.append_upsert if op == "upsert" else w.append_delete)(payload)
    if durable:
        w.close()
    else:
        w.flush(path)


@pytest.mark.parametrize("durable", [False, True], ids=["explicit", "durable"])
def test_wal_same_bytes_and_cross_read(tmp_path, durable):
    j_path, t_path = tmp_path / "1.wal", tmp_path / "2.wal"
    _write(j_wal, j_path, durable)
    _write(t_wal, t_path, durable)
    assert j_path.read_bytes() == t_path.read_bytes()
    want = j_wal.read_wal(j_path)
    assert t_wal.read_wal(j_path) == want == j_wal.read_wal(t_path) == t_wal.read_wal(t_path)
    header, ops = want
    assert [op for op, _ in ops] == [t_wal.OP_UPSERT, t_wal.OP_DELETE, t_wal.OP_UPSERT, t_wal.OP_DELETE]
    if durable:
        assert header == {"durable": True}
        assert t_wal.read_durable_wal(j_path) == j_wal.read_durable_wal(t_path)
    else:
        assert header == {"upserted": 3, "deleted": 2, "total_ops": 4}


def _versions(vcs):
    out = []
    for v in vcs.list_versions():
        v = dict(v)
        v.pop("created_at")
        out.append(v)
    return out, vcs.current_version, vcs.background_version, vcs.unindexed_versions()


def _sequence(vcs):
    for i in range(3):
        v = vcs.allot_version()
        vcs.set_current_version(v, {"kind": "explicit", "txn_id": f"t{i}"}, upserted=10 * i, deleted=i, total_ops=i + 1)
    vcs.update_background_version(2)
    vcs.update_background_version(1)  # monotonic: stays at 2
    v = vcs.allot_version()
    vcs.set_current_version(v, {"kind": "implicit", "epoch_id": 5})
    return _versions(vcs)


def test_version_control_matches_reference_over_one_metastore(tmp_path):
    path = tmp_path / "meta.sqlite"
    jm = j_meta.MetaStore(path)
    want = _sequence(j_versioning.VersionControl(jm, "ref"))
    tm = t_meta.MetaStore(path)
    assert _sequence(t_versioning.VersionControl(tm, "port")) == want
    assert want[1:] == (4, 2, [3, 4])
    # each package reads the versions the other wrote
    assert _versions(t_versioning.VersionControl(tm, "ref")) == want
    assert _versions(j_versioning.VersionControl(jm, "port")) == want
    assert tm.get("versions:ref", ("info", 1)) == jm.get("versions:ref", ("info", 1))
    jm.close()
    tm.close()


def test_chunked_files_match_reference(tmp_path):
    arr = np.random.default_rng(0).integers(-128, 128, size=(300, 32), dtype=np.int8)
    t_chunked.save_chunked(tmp_path / "t", "data", arr, None)
    j_chunked.save_chunked(tmp_path / "j", "data", arr, None)
    for f in sorted((tmp_path / "j").iterdir()):
        assert (tmp_path / "t" / f.name).read_bytes() == f.read_bytes()
    np.testing.assert_array_equal(j_chunked.load_chunked(tmp_path / "t", "data"), arr)
    np.testing.assert_array_equal(t_chunked.load_chunked(tmp_path / "j", "data"), arr)


def _collection(tmp_path, meta, quantization=None, schema=None):
    cfg = {"name": "c", "dense_vector": {"enabled": True, "dimension": DIM}}
    if schema:
        cfg["metadata_schema"] = schema
    coll = Collection(meta, tmp_path, cfg, "cpu")
    coll.create_dense_index(quantization=quantization or {"type": "auto", "sample_threshold": 100})
    return coll


def _chunk_files(snap, name):
    return sorted(p.name for p in snap.glob(f"{name}.c*.npy"))


def test_snapshot_rewrites_only_dirty_chunks(tmp_path, monkeypatch):
    monkeypatch.setattr(t_chunked, "CHUNK_ROWS", 256)
    x, q = _unit(700, 0), _unit(8, 1)
    meta = t_meta.MetaStore(tmp_path / "meta.sqlite")
    coll = _collection(tmp_path, meta)
    coll.index_embeddings([{"id": i, "dense_values": x[i].tolist()} for i in range(600)])
    coll.flush_indexes()
    coll.save_snapshot()
    snap = coll.data_dir / "snapshot"
    first = {n: _chunk_files(snap, n) for n in ("data", "raw")}
    assert [len(v) for v in first.values()] == [4, 4]  # capacity 1024 rows = 4 chunks
    coll.index_embeddings([{"id": i, "dense_values": x[i].tolist()} for i in range(600, 700)])
    coll.delete_embedding(3)
    coll.save_snapshot()
    for name, before in first.items():
        after = _chunk_files(snap, name)
        # rows 600-699 lie in chunk 2 only: chunks 0, 1 and 3 keep their files
        assert [f for f in after if f in before] == [f for f in before if ".c2." not in f], name
        assert len([f for f in after if ".c2." in f and f not in before]) == 1, name
    np.testing.assert_array_equal(
        t_chunked.load_chunked(snap, "data"), coll.dense.index.store.arrays.data.numpy()
    )
    # the snapshot loads back into a fresh collection and answers the same
    want = coll.search_dense(q, K)
    fresh = Collection(meta, tmp_path, coll.config, "cpu")
    fresh.restore_indexes_from_meta()
    load_collection_state(fresh, snap)
    assert fresh.search_dense(q, K) == want
    assert fresh.get_vector(5) == coll.get_vector(5) and fresh.get_vector(3) is None
    assert fresh.dense.index.store.tracker.gen == coll.dense.index.store.tracker.gen
    meta.close()


@pytest.mark.parametrize("data_type", ["u8", "quaternary", "f32"])
def test_compaction_shrinks_the_store_and_keeps_answers(tmp_path, data_type):
    x, q = _unit(1000, 2), _unit(16, 3)
    schema = {"fields": [{"name": "color", "values": ["red", "blue"]}], "supported_conditions": []}
    quant = {"type": "scalar", "data_type": data_type, "range": {"min": -0.4, "max": 0.4}}
    meta = t_meta.MetaStore(tmp_path / "meta.sqlite")
    coll = _collection(tmp_path, meta, quant, schema)
    coll.index_embeddings([
        {"id": i, "dense_values": x[i].tolist(), "metadata": {"color": "red" if i % 3 else "blue"}}
        for i in range(1000)
    ])
    for i in range(0, 1000, 10):  # 30% tombstones
        coll.delete_embedding(i)
        coll.delete_embedding(i + 1)
        coll.delete_embedding(i + 2)
    red = {"Is": {"field_name": "color", "field_value": "red", "operator": "Equal"}}
    want = coll.search_dense(q, K), coll.search_dense(q, K, filter_dto=red)
    old = coll.dense.index
    assert (old.n, old.n_deleted) == (1000, 300)
    coll.flush_indexes()
    new = coll.dense.index
    assert new is not old and (new.n, new.n_deleted, coll.dense._gen) == (700, 0, 1)
    assert (new.store.kind, new.store.resolution, new.store.range) == (
        old.store.kind, old.store.resolution, old.store.range
    )
    got = coll.search_dense(q, K), coll.search_dense(q, K, filter_dto=red)
    if data_type != "quaternary":
        assert got == want
    else:
        alive = np.asarray([i for i in range(1000) if i % 10 > 2])
        truth = alive[np.argsort(-(q @ x[alive].T), axis=1)[:, :K]]

        def recall(res):
            return np.mean([len({r["id"] for r in row} & set(t)) / K for row, t in zip(res, truth)])

        assert recall(got[0]) >= recall(want[0]) - 0.02
        for res in got:  # exact f32 rerank scores of live rows
            for row, qv in zip(res, q):
                ids = [r["id"] for r in row]
                assert all(i % 10 > 2 for i in ids)
                np.testing.assert_allclose([r["score"] for r in row], x[ids] @ qv, rtol=1e-5, atol=1e-6)
    assert coll.get_vector(5)["dense_values"] == pytest.approx(x[5].tolist(), abs=0)
    # below the threshold nothing is rebuilt
    coll.delete_embedding(5)
    coll.flush_indexes()
    assert coll.dense.index is new
    # a handle's row mask follows the renumbered rows
    mask = coll.dense.row_mask_for(compile_filter(MetadataSchema(schema), red))
    assert mask.shape == (700,)
    meta.close()


def test_compaction_needs_raw_rows():
    h = DenseIndexHandle(DIM, "cpu", quantization={"type": "scalar", "data_type": "u8"}, raw_storage="none")
    x = _unit(100, 4)
    h.add_batch(list(range(100)), x)
    for i in range(50):
        h.delete(i)
    h.flush()
    assert h.index.n == 100 and h.index.n_deleted == 50


@pytest.mark.parametrize("data_type", ["u8"])
def test_compaction_rebuilds_the_graph(data_type):
    """Compaction rebuilds the graph from the live rows (insertion waves
    below the bulk threshold), as the reference's does: the new graph holds
    only live rows, draws the reference's levels, and its answers above
    the serving limits match the reference's compacted graph (ids where
    untied, recall within 0.02)."""
    from cosdata_tpu.core.collection import DenseIndexHandle as JHandle
    from cosdata_tpu.ops import storage as JS

    x, q = _unit(900, 5), _unit(16, 6)
    quant = {"type": "scalar", "data_type": data_type, "range": {"min": -0.4, "max": 0.4}}
    params = {"ef_construction": 64, "wave_size": 256}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        ref = JHandle(DIM, quantization=quant, hnsw_params=params)
        port = DenseIndexHandle(DIM, "cpu", quantization=quant, hnsw_params=params)
        for h in (ref, port):
            h.add_batch(list(range(900)), x)
            for i in range(0, 900, 3):
                h.delete(i)
            h.flush()
            h.flat_serve_threshold = h.graph_filter_min = 100
        j_ids, j_sc = ref.search(q, K)
    t = port.index
    assert (t.n, t.n_deleted, port._gen) == (600, 0, 1) and not t.scan_only
    assert t.adj0[:600].max() < 600 and (t.adj0[600:] == -1).all()
    np.testing.assert_array_equal(t.levels[:600], ref.index.levels[:600])
    t_ids, t_sc = port.search(q, K)
    assert not (t_ids % 3 == 0).any() and (t_ids >= 0).all()
    live = np.asarray([i for i in range(900) if i % 3])
    truth = live[np.argsort(-(q @ x[live].T), axis=1)[:, :K]]

    def recall(ids):
        return np.mean([len(set(a) & set(b)) / K for a, b in zip(ids, truth)])

    assert recall(t_ids) >= recall(j_ids) - 0.02
    same = (t_ids == j_ids).all(1)
    assert same.mean() >= 0.5
    np.testing.assert_allclose(t_sc[same], j_sc[same], rtol=1e-5, atol=1e-6)
