"""The Python SDK (clients/python/cosdata_tpu_client.py) against the port's
REST server: tests/test_sdk.py's two scenarios (the end-to-end run of
collection, dense and tf-idf indexes, a 60-row transaction, dense, text and
hybrid search, GET by id, the version and a 404; and a transaction aborted
by an exception, then a new one) run through the client against
``cosdata_tpu_torch.api.server`` on the CPU and against the reference's
server on the same seeded inputs. Every answer must equal the reference's:
JSON equal with timestamps, transaction ids and rates masked, scores
within rtol 1e-5, and result ids equal where the reference's scores are
untied.

The reference's dense indexes are kept off their graph build (scan-only
from construction, as the port's are at this size) and its wire probe is
pinned fast, so it ships exact f32 rows and queries as the port does."""

import asyncio
import socket
import sys
import threading
from contextlib import contextmanager
from pathlib import Path

import numpy as np
import pytest

from cosdata_tpu.api.server import make_app as j_make_app
from cosdata_tpu.config import load_config as j_load_config
from cosdata_tpu.core.app_context import AppContext as JAppContext
from cosdata_tpu.indexes import hnsw as JH
from cosdata_tpu.ops import storage as JS
from cosdata_tpu_torch.api.server import make_app as t_make_app
from cosdata_tpu_torch.config import load_config as t_load_config
from cosdata_tpu_torch.core.app_context import AppContext as TAppContext

sys.path.insert(0, str(Path(__file__).parent.parent / "clients" / "python"))
from cosdata_tpu_client import Client, ClientError  # noqa: E402

ADMIN = "sdk"
#: values that differ between two runs of the same script
VARYING = {
    "transaction_id", "created_at", "access_token", "expires_at", "txn_id", "epoch_id",
    "processing_time_seconds", "average_throughput", "current_processing_rate",
    "estimated_completion", "last_updated",
}


@contextmanager
def _serve(app):
    """``app`` on a local port from a thread's event loop; yields host:port."""
    from aiohttp import web

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    loop = asyncio.new_event_loop()
    started = threading.Event()
    runner = web.AppRunner(app)

    async def run():
        await runner.setup()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        started.set()

    thread = threading.Thread(target=lambda: (loop.create_task(run()), loop.run_forever()), daemon=True)
    thread.start()
    assert started.wait(30)
    try:
        yield f"127.0.0.1:{port}"
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        assert not thread.is_alive()


def _unit(n, d, seed):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _end_to_end(host) -> dict:
    """tests/test_sdk.py's test_end_to_end, each answer recorded."""
    out = {}
    c = Client(host, admin_key=ADMIN)
    out["create_collection"] = c.create_collection("sdkc", dense_dimension=32, tf_idf=True, store_raw_text=True)
    out["create_dense_index"] = c.create_dense_index(
        "sdkc", quantization={"type": "auto", "sample_threshold": 40}, hnsw_params={"num_layers": 2}
    )
    out["create_tf_idf_index"] = c.create_tf_idf_index("sdkc", sample_threshold=5)
    x = _unit(60, 32, 0)
    with c.transaction("sdkc") as txn:
        out["upsert"] = txn.upsert(
            [{"id": f"v{i}", "dense_values": x[i].tolist(), "text": f"note number {i} topic{i % 3}"}
             for i in range(60)]
        )
    out["indexing_status"] = c.wait_for_indexing("sdkc")
    out["search_dense"] = c.search_dense("sdkc", x[11], top_k=3)
    assert out["search_dense"][0]["id"] == "v11"
    out["search_dense_raw_text"] = c.search_dense("sdkc", x[40], top_k=5, return_raw_text=True)
    out["search_tf_idf"] = c.search_tf_idf("sdkc", "topic1", top_k=5)
    assert out["search_tf_idf"]
    out["search_tf_idf_rare"] = c.search_tf_idf("sdkc", "number 17 notes", top_k=5)
    out["search_hybrid"] = c.search_hybrid("sdkc", query_vector=x[4].tolist(), query_text="topic1", top_k=5)
    assert out["search_hybrid"]
    out["get_vector"] = c.get_vector("sdkc", "v3")
    assert out["get_vector"]["id"] == "v3"
    out["current_version"] = c.current_version("sdkc")
    assert out["current_version"]["version"] == 1
    with pytest.raises(ClientError) as e:
        c.get_vector("sdkc", "ghost")
    out["get_missing"] = (e.value.status, str(e.value))
    assert e.value.status == 404
    return out


def _abort_on_error(host) -> dict:
    """tests/test_sdk.py's test_transaction_abort_on_error, each answer recorded."""
    out = {}
    c = Client(host, admin_key=ADMIN)
    out["abort_create_collection"] = c.create_collection("ab", dense_dimension=8)
    with pytest.raises(RuntimeError, match="boom"):
        with c.transaction("ab") as txn:
            out["abort_upsert"] = txn.upsert([{"id": "a", "dense_values": [0.1] * 8}])
            raise RuntimeError("boom")
    # transaction aborted -> a new one can open
    with c.transaction("ab") as txn:
        out["abort_second_upsert"] = txn.upsert([{"id": "a", "dense_values": [0.1] * 8}])
    out["abort_versions"] = c.list_versions("ab")
    return out


def _script(host) -> dict:
    return {**_end_to_end(host), **_abort_on_error(host)}


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JS, "_WIRE_BW_MBPS", 1e9)
        init = JH.HNSWIndex.__init__

        def scan_only_init(self, *a, **kw):
            init(self, *a, **kw)
            self.scan_only = True

        mp.setattr(JH.HNSWIndex, "__init__", scan_only_init)
        jctx = JAppContext(j_load_config(data_path=str(tmp_path_factory.mktemp("ref"))), admin_key=ADMIN)
        try:
            with _serve(j_make_app(jctx)) as host:
                ref = _script(host)
        finally:
            jctx.indexing.stop()
            jctx.meta.close()
    tctx = TAppContext(t_load_config(data_path=str(tmp_path_factory.mktemp("port"))), admin_key=ADMIN, device="cpu")
    try:
        with _serve(t_make_app(tctx)) as host:
            port = _script(host)
    finally:
        tctx.close()
    return ref, port


def _untied(s, rtol=1e-5):
    s = np.asarray(s, np.float64)
    tol = rtol * np.abs(s) + 1e-7
    gap = s[:-1] - s[1:]
    prev = np.concatenate([[np.inf], gap])
    nxt = np.concatenate([gap, [np.inf]])
    return (prev > tol) & (nxt > tol)


def _compare(t, j):
    """Equal JSON with the varying values masked, floats within rtol 1e-5,
    and ranked hits (dicts with a score) equal by id where untied."""
    if isinstance(j, list) and j and isinstance(j[0], dict) and "score" in j[0]:
        assert len(t) == len(j)
        np.testing.assert_allclose([r["score"] for r in t], [r["score"] for r in j], rtol=1e-5, atol=1e-6)
        for a, b, ok in zip(t, j, _untied([r["score"] for r in j])):
            if ok:
                assert {k: v for k, v in a.items() if k != "score"} == {k: v for k, v in b.items() if k != "score"}
    elif isinstance(j, dict):
        assert isinstance(t, dict) and set(t) == set(j), (t, j)
        for k in j:
            if k not in VARYING:
                _compare(t[k], j[k])
    elif isinstance(j, (list, tuple)):
        assert isinstance(t, type(j)) and len(t) == len(j), (t, j)
        for a, b in zip(t, j):
            _compare(a, b)
    elif isinstance(j, float):
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    else:
        assert t == j


STEPS = [
    "create_collection", "create_dense_index", "create_tf_idf_index", "upsert", "indexing_status",
    "search_dense", "search_dense_raw_text", "search_tf_idf", "search_tf_idf_rare", "search_hybrid",
    "get_vector", "current_version", "get_missing", "abort_create_collection", "abort_upsert",
    "abort_second_upsert", "abort_versions",
]


@pytest.mark.parametrize("step", STEPS)
def test_sdk_step_matches_reference(answers, step):
    ref, port = answers
    assert set(port) == set(ref) == set(STEPS)
    _compare(port[step], ref[step])


def test_sdk_answers_hold_on_the_port(answers):
    _, port = answers
    assert [h["id"] for h in port["search_dense"]][0] == "v11"
    assert all(h["text"] for h in port["search_dense_raw_text"])
    assert {h["id"] for h in port["search_tf_idf"]} <= {f"v{i}" for i in range(1, 60, 3)}
    assert port["search_tf_idf_rare"][0]["id"] == "v17"
    assert port["get_vector"]["dense_values"] == pytest.approx(_unit(60, 32, 0)[3].tolist(), abs=1e-6)
    assert len(port["abort_versions"]) == 2
