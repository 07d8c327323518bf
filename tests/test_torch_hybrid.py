"""Hybrid search: the port's ``rrf_fuse`` (cosdata_tpu_torch/core/fusion.py)
and ``Collection.hybrid_search_batch`` against the reference's on the same
inputs. Both collections (device "cpu" for the port) hold a u8 "auto"
dense index over 1,500 x 32 unit rows, a sparse index over a zipf corpus
(vocab 600, 16 pairs per doc) and a tf-idf index over zipf texts (words
w0..w799, 24 per doc), numpy seeds 0, 1 and 2, with a few deletes; 24
queries pair a perturbed doc vector with the doc's 6 rarest dims, some with
a per-query early-termination threshold (a second sparse leg group), and
24 more pair the vector or the dims with the doc's 4 rarest words (the
``query_text`` leg).

Tolerance: scores rtol 1e-5, atol 1e-6. Fused ids must be equal where the
reference's fused scores are untied; tie groups inside a list are compared
as sets, and the group at the end of a list by its scores only. The
reference's dense index is kept off its graph build and its wire probe is
pinned fast, as in test_torch_api.py."""

import numpy as np
import pytest
import torch

from cosdata_tpu.config import load_config as j_load_config
from cosdata_tpu.core.app_context import AppContext as JAppContext
from cosdata_tpu.core.fusion import rrf_fuse as j_rrf_fuse
from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.config import load_config as t_load_config
from cosdata_tpu_torch.core.app_context import AppContext as TAppContext
from cosdata_tpu_torch.core.fusion import rrf_fuse as t_rrf_fuse

torch.set_num_threads(1)
RTOL, ATOL = 1e-5, 1e-6
ADMIN = "hybrid-key"
N, DIM, VOCAB, NNZ, NQ, K = 1500, 32, 600, 16, 24, 10


def _data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(N, DIM)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    srng = np.random.default_rng(1)
    dims = (srng.pareto(1.2, size=(N, NNZ)) * 15).astype(np.int64) % VOCAB
    vals = srng.gamma(2.0, 0.8, size=(N, NNZ)).astype(np.float32)
    words = np.random.default_rng(2).pareto(1.1, size=(N, 24)).astype(np.int64) % 800
    vectors = [
        {"id": i, "dense_values": x[i].tolist(),
         "sparse_values": [[int(d), float(v)] for d, v in zip(dims[i], vals[i])],
         "text": " ".join(f"w{w}" for w in words[i])}
        for i in range(N)
    ]
    queries, text_queries = [], []
    for j in range(NQ):
        pick = np.argsort(dims[j])[-6:]
        qv = x[j] + 0.3 * rng.normal(size=DIM).astype(np.float32)
        terms = [(int(d), float(v)) for d, v in zip(dims[j][pick], vals[j][pick])]
        q = {"query_vector": qv.tolist(), "query_terms": terms}
        if j % 3 == 2:
            q["sparse_early_terminate_threshold"] = 0.5
        queries.append(q)
        other = {"query_vector": qv.tolist()} if j % 2 else {"query_terms": terms}
        text_queries.append({**other, "query_text": " ".join(f"w{w}" for w in np.sort(words[j])[-4:])})
    return vectors, queries, text_queries


def _collection(ctx, vectors):
    coll = ctx.create_collection({
        "name": "hy", "dense_vector": {"enabled": True, "dimension": DIM}, "sparse_vector": {"enabled": True},
        "tf_idf_options": {"enabled": True},
    })
    coll.create_dense_index(quantization={"type": "auto", "sample_threshold": 100})
    coll.create_sparse_index(quantization=64, sample_threshold=200)
    coll.create_tf_idf_index(sample_threshold=200)
    coll.index_embeddings(vectors)
    for i in (4, 40, 400):
        coll.delete_embedding(i)
    coll.flush_indexes()
    return coll


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    vectors, queries, text_queries = _data()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        init = JH.HNSWIndex.__init__

        def scan_only_init(self, *a, **kw):
            init(self, *a, **kw)
            self.scan_only = True

        mp.setattr(JH.HNSWIndex, "__init__", scan_only_init)
        jctx = JAppContext(j_load_config(data_path=str(tmp_path_factory.mktemp("ref"))), admin_key=ADMIN)
        jcoll = _collection(jctx, vectors)
        out["ref"] = jcoll.hybrid_search_batch(queries, top_k=K)
        out["ref_fc"] = jcoll.hybrid_search_batch(queries[:6], top_k=5, fusion_constant_k=10.0)
        out["ref_text"] = jcoll.hybrid_search_batch(text_queries, top_k=K)
        jctx.indexing.stop()
        jctx.meta.close()
    tctx = TAppContext(t_load_config(data_path=str(tmp_path_factory.mktemp("port"))), admin_key=ADMIN,
                       device="cpu")
    try:
        tcoll = _collection(tctx, vectors)
        out["port"] = tcoll.hybrid_search_batch(queries, top_k=K)
        out["port_fc"] = tcoll.hybrid_search_batch(queries[:6], top_k=5, fusion_constant_k=10.0)
        out["port_one"] = [tcoll.hybrid_search(q, top_k=K) for q in queries[:3]]
        out["port_text"] = tcoll.hybrid_search_batch(text_queries, top_k=K)
        out["port_text_one"] = [tcoll.hybrid_search(q, top_k=K) for q in text_queries[:2]]
        with pytest.raises(ValueError, match="two of"):
            tcoll.hybrid_search_batch([{"query_vector": queries[0]["query_vector"]}])
    finally:
        tctx.close()
    return out


def _same_lists(t_lists, j_lists):
    assert len(t_lists) == len(j_lists)
    for t_row, j_row in zip(t_lists, j_lists):
        assert len(t_row) == len(j_row) > 0
        js = np.asarray([r["score"] for r in j_row], np.float64)
        np.testing.assert_allclose([r["score"] for r in t_row], js, rtol=RTOL, atol=ATOL)
        ti = [r["id"] for r in t_row]
        ji = [r["id"] for r in j_row]
        start = 0
        for pos in range(1, len(js)):
            if js[pos - 1] - js[pos] > RTOL * abs(js[pos - 1]) + ATOL:
                assert set(ti[start:pos]) == set(ji[start:pos]), (ti, ji)
                start = pos


def test_hybrid_batch_matches_reference(runs):
    _same_lists(runs["port"], runs["ref"])


def test_fusion_constant_matches_reference(runs):
    _same_lists(runs["port_fc"], runs["ref_fc"])


def test_text_hybrid_matches_reference(runs):
    """A query_text leg beside a dense or a sparse leg, fused as the
    reference fuses it; a lone query equals its batch row."""
    _same_lists(runs["port_text"], runs["ref_text"])
    for one, row in zip(runs["port_text_one"], runs["port_text"]):
        assert [r["id"] for r in one] == [r["id"] for r in row]
    assert np.mean([j in {r["id"] for r in row} for j, row in enumerate(runs["port_text"])]) >= 0.8


def test_single_hybrid_equals_batch_row(runs):
    for one, row in zip(runs["port_one"], runs["port"]):
        assert [r["id"] for r in one] == [r["id"] for r in row]


def test_hybrid_finds_its_doc_and_skips_deleted(runs):
    """Query j is doc j's own terms plus its perturbed vector: the port
    finds doc j exactly where the reference does, and most of the time."""
    def hits(lists):
        return [j in {r["id"] for r in row} for j, row in enumerate(lists)]

    assert hits(runs["port"]) == hits(runs["ref"])
    assert np.mean(hits(runs["port"])) >= 0.8
    assert all(r["id"] not in (4, 40, 400) for row in runs["port"] for r in row)


@pytest.mark.parametrize("k,fetch,k_rrf", [(10, 30, 60.0), (5, 12, 1.0), (30, 30, 60.0)])
def test_rrf_fuse_matches_reference(k, fetch, k_rrf):
    rng = np.random.default_rng(k)
    legs = []
    for _ in range(2):
        leg = rng.integers(0, 50, size=(16, fetch))
        leg[rng.random((16, fetch)) < 0.15] = -1
        legs.append(leg)
    t_ids, t_sc = t_rrf_fuse(legs, k, fetch, k_rrf)
    j_ids, j_sc = j_rrf_fuse(legs, k, fetch, k_rrf)
    np.testing.assert_array_equal(t_ids, j_ids)
    np.testing.assert_array_equal(t_sc, j_sc)
