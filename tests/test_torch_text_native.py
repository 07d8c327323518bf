"""The port's native text pipeline (cosdata_tpu_torch/csrc/text_pipeline.cpp,
built by cosdata_tpu_torch/text/native.py) against its plain Python
version (text/processing.py's ``*_plain`` functions), bit for bit: term
ids, their order, the document length, each tf as a double and the f32 an
index stores.

- Inputs: the reference's native test documents (tests/test_native_text.py),
  2,000 documents of the phase-16 corpus, a fixed Unicode corpus (one case
  per line, ``tools/text_check.py``) and hypothesis draws over all of
  Unicode, surrogates included (derandomized, so the count is the same in
  every run).
- ``TFIDFIndex`` on the CPU, built through the library and through the
  plain version: the same postings, CSR arrays and doc rows, and the same
  search ids and scores at b1 and b64.
- Threads calling the library together get the plain answers (each thread
  owns its buffers and stem cache).
- The build: the library's name carries the interpreter's Unicode version,
  a copy of the source builds and answers alike, a newer source is rebuilt,
  and a source that does not compile raises.
"""

import os
import shutil
import sys
import threading
import unicodedata

import numpy as np
import pytest
import torch
import xxhash
from hypothesis import given, settings
from hypothesis import strategies as st

from cosdata_tpu_torch.indexes import tf_idf as TF
from cosdata_tpu_torch.ops.kernels.nvcc import needs_build
from cosdata_tpu_torch.text import native as N
from cosdata_tpu_torch.text import processing as TP
from cosdata_tpu_torch.tools.text_check import UNICODE_CORPUS, bm25_corpus, differences

#: tests/test_native_text.py's DOCS
NATIVE_DOCS = [
    "The quick brown fox jumps over the lazy dog",
    "generalization of internationalization strategies",
    "running runs runner ran; dying lying tying skies skis",
    "a_token_with_underscores and numbers like 42 or x86_64",
    "conditional rationalization of sensational electrical traditions",
    "'quoted' words and trailing apostrophes' here",
]
#: (max_token_len, avg_doc_len, k1, b)
PARAMS = [(40, 7.0, 1.2, 0.75), (6, 3.5, 2.0, 0.3)]


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("doc", NATIVE_DOCS)
def test_reference_native_docs(doc, params):
    assert differences([doc], *params) == []
    assert TP.process_text(doc) and TP.count_tokens(doc) > 0


@pytest.mark.parametrize("params", PARAMS)
@pytest.mark.parametrize("case", range(len(UNICODE_CORPUS)))
def test_unicode_case(case, params):
    assert differences([UNICODE_CORPUS[case]], *params) == []


def test_unicode_cases_that_the_plain_path_decides():
    """What each hard case must give (checked here against the plain
    version, which the cases above hold the library to)."""
    assert TP.count_tokens("ж" * 21 + " " + "ж" * 20) == 1  # 42 bytes cut, 40 kept
    assert TP.process_text_query("ΟΔΟΣ") == TP.process_text_query("οδος")  # final sigma
    assert TP.process_text_query("ΟΔΟΣ") != TP.process_text_query("οδοσ")
    assert TP.count_tokens("nul\x00byte") == 2 and TP.count_tokens("lone\ud800surrogate") == 2
    assert TP.process_text("") == [] and TP.count_tokens("") == 0 and TP.process_text_query("") == []
    # "İ" lowers to "i" + U+0307, two code points: too short to stem
    assert TP.process_text_query("İ") == [xxhash.xxh32("i\u0307".encode("utf-8"), seed=0).intdigest()]


def test_a_zero_average_length_raises_as_python_does():
    """An index whose sampled documents hold no kept token has avgdl 0: the
    plain version raises on the first document with a term, and so does
    the library; a document without terms divides by nothing."""
    for fn in (TP.process_text, TP.process_text_plain):
        with pytest.raises(ZeroDivisionError):
            fn("hello world", 40, 0.0)
        assert fn("the a of", 40, 0.0) == []


def test_phase16_corpus():
    docs, ids = bm25_corpus(2000)
    queries = [" ".join(f"w{w}" for w in np.sort(ids[j])[-6:]) for j in range(64)]
    assert differences(docs, 40, 40.0) == []
    assert differences(queries, 40, 40.0) == []
    assert sum(TP.count_tokens(d) for d in docs) == 2000 * 40


_UNICODE = st.characters(exclude_categories=())
_TEXT = st.text(st.one_of(_UNICODE, st.sampled_from("aeiouysnlrtgΣσςİıIK_0 ")), max_size=80)


@settings(derandomize=True, max_examples=500, deadline=None, database=None)
@given(_TEXT)
def test_hypothesis_over_all_of_unicode(text):
    for params in PARAMS:
        assert differences([text], *params) == []


def _index(docs, plain: bool, monkeypatch) -> TF.TFIDFIndex:
    if plain:
        monkeypatch.setattr(TF, "process_text", TP.process_text_plain)
        monkeypatch.setattr(TF, "count_tokens", TP.count_tokens_plain)
        monkeypatch.setattr(TF, "process_text_query", TP.process_text_query_plain)
    idx = TF.TFIDFIndex("cpu", sample_threshold=300)
    for i, d in enumerate(docs):
        idx.add(i, d)
    idx.delete(7)
    idx.flush()
    idx.search(["w0"], 10)  # builds the CSR and the doc rows
    monkeypatch.undo()
    return idx


@pytest.fixture(scope="module")
def indexes():
    docs, ids = bm25_corpus(1500)
    mixed = [d + " " + UNICODE_CORPUS[i % len(UNICODE_CORPUS)] for i, d in enumerate(docs)]
    queries = [" ".join(f"w{w}" for w in np.sort(ids[j])[-6:]) + " " + UNICODE_CORPUS[j % 9] for j in range(64)]
    with pytest.MonkeyPatch.context() as mp:
        lib = _index(mixed, False, mp)
        plain = _index(mixed, True, mp)
    return lib, plain, queries


def test_index_state_is_identical(indexes):
    lib, plain, _ = indexes
    assert lib.average_document_length == plain.average_document_length
    assert list(lib._postings) == list(plain._postings) and lib._postings == plain._postings
    assert [[x.hex() for x in lib._tfs[t]] for t in lib._tfs] == [[x.hex() for x in plain._tfs[t]] for t in plain._tfs]
    for name in ("_h_tfs", "_h_ids_sorted", "_term_sorted", "_term_start", "_tf_cnt", "_live_df_arr"):
        a, b = getattr(lib, name), getattr(plain, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("_csr_ids", "_csr_vals", "_doc_terms_dev", "_doc_tfs_dev"):
        assert torch.equal(getattr(lib, name), getattr(plain, name)), name


@pytest.mark.parametrize("batch", [1, 64])
def test_index_answers_are_identical(indexes, batch, monkeypatch):
    lib, plain, queries = indexes
    want_ids, want_sc = [], []
    monkeypatch.setattr(TF, "process_text_query", TP.process_text_query_plain)
    for s in range(0, 64, batch):
        i, sc = plain.search(queries[s : s + batch], 10)
        want_ids.append(i)
        want_sc.append(sc)
    monkeypatch.undo()
    for n, s in enumerate(range(0, 64, batch)):
        ids, sc = lib.search(queries[s : s + batch], 10)
        assert np.array_equal(ids, want_ids[n]) and np.array_equal(sc, want_sc[n])
    assert (np.concatenate(want_ids)[:, 0] >= 0).all()


def test_threads_share_nothing():
    """24 threads (more than the cores) call the library at once under a
    short switch interval; every answer equals the plain version's."""
    docs, _ = bm25_corpus(600)
    texts = [d + " " + UNICODE_CORPUS[i % len(UNICODE_CORPUS)] for i, d in enumerate(docs)]
    want = [TP.process_text_plain(t, 40, 9.0) for t in texts]
    bad, done = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            order = texts[k:] + texts[:k]  # each thread starts elsewhere
            for j, t in enumerate(order):
                if TP.process_text(t, 40, 9.0) != want[(k + j) % len(texts)]:
                    bad.append((k, j))
            done.append(k)

        threads = [threading.Thread(target=work, args=(k * 25,)) for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == [k * 25 for k in range(24)] and not bad


def test_library_name_carries_the_unicode_version():
    assert f"_u{unicodedata.unidata_version}.so" in N.LIBRARY.library.name
    assert N.LIBRARY.library.parent.name == "build"
    N.LIBRARY.load()
    assert not needs_build(N.LIBRARY.library, N.LIBRARY.inputs())


def test_a_copy_builds_rebuilds_and_a_broken_source_raises(tmp_path):
    src = tmp_path / "text_pipeline.cpp"
    shutil.copy(N.SOURCE, src)
    lib = N.TextLibrary(src, tmp_path / "build" / "libtext_copy.so")
    assert lib.build() > 0
    assert lib.terms("Straße ΟΔΟΣ runs", 40, True, 2.0) == N.LIBRARY.terms("Straße ΟΔΟΣ runs", 40, True, 2.0)
    built = lib.library.stat().st_mtime
    os.utime(src, (built + 10, built + 10))
    assert needs_build(lib.library, lib.inputs())
    again = N.TextLibrary(src, lib.library)
    again.load()
    assert lib.library.stat().st_mtime > built and not list(lib.library.parent.glob("*.tmp"))
    src.write_text("int broken(;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        N.TextLibrary(src, tmp_path / "build" / "libtext_broken.so").load()
