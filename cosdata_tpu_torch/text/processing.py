"""BM25 text pipeline (port of ``cosdata_tpu/text/processing.py``), matching
the reference's semantics so that scores are comparable
(upstream src/indexes/tf_idf/mod.rs:282-399):

tokenize (runs of ``\\w``) → lowercase → 35-stopword filter → Snowball
English stem → xxhash32 (seed 0) term id → BM25 term frequency normalized
with k1/b at index time.

Host-side by design: stemming and hashing are branchy string work; the
device sees only the resulting (term id, tf) postings.

Changed from the reference: one code path for every document and query.
``process_text``, ``count_tokens`` and ``process_text_query`` go through the
native library (``csrc/text_pipeline.cpp``, built at first use by
``text/native.py``), on every input, ASCII or not; there is no fallback
between two paths. The functions ending in ``_plain`` are the same
pipeline in Python, with the port's own stemmer (``text/stemmer.py``,
held against nltk 3.10); the library equals them bit for bit, and the
tests and ``chip_smoke.py`` hold it to them. The BM25 tf is computed in
double precision, as the reference's Python path computes it; its native
ASCII path computes in f32 and agrees to rtol 1e-6. Indexes store the tf
as f32.
"""

from __future__ import annotations

import re
from functools import lru_cache

import xxhash

from cosdata_tpu_torch.text.native import LIBRARY
from cosdata_tpu_torch.text.stemmer import stem

# the reference's 35 stopwords (tf_idf/mod.rs:282-286)
STOPWORDS = frozenset(
    [
        "a", "and", "are", "as", "at", "be", "but", "by", "for", "if", "in",
        "into", "is", "it", "no", "not", "of", "on", "or", "s", "such", "t",
        "that", "the", "their", "then", "there", "these", "they", "this",
        "to", "was", "will", "with", "www",
    ]
)


def count_tokens(text: str, max_token_len: int = 40) -> int:
    """Document length: the count of kept non-stopword tokens (mod.rs:373-389)."""
    return LIBRARY.terms(text, max_token_len, False)[0]


def process_text(
    text: str,
    max_token_len: int = 40,
    avg_doc_len: float = 1.0,
    k1: float = 1.2,
    b: float = 0.75,
) -> list[tuple[int, float]]:
    """Document → [(term id u32, bm25 tf)] (mod.rs:310-360), each term in
    its first occurrence's order."""
    _, ids, tfs = LIBRARY.terms(text, max_token_len, True, avg_doc_len, k1, b)
    return list(zip(ids, tfs))


def process_text_query(text: str, max_token_len: int = 40) -> list[int]:
    """Query → its unique term ids (search_bm25 uses the ids only,
    sparse_ann_query.rs:161-180)."""
    return LIBRARY.terms(text, max_token_len, True)[1]


# ------------------------------------------------ the plain Python version

# Rust char::is_alphanumeric() or '_' (tf_idf/mod.rs:288-308); Python's \w
# covers the same classes (letters, digits, underscore)
_TOKEN_RE = re.compile(r"\w+", re.UNICODE)


def tokenize(text: str) -> list[str]:
    return _TOKEN_RE.findall(text)


@lru_cache(maxsize=65536)
def _stem_hash(lower_token: str) -> int:
    return xxhash.xxh32(stem(lower_token).encode("utf-8"), seed=0).intdigest()


def _tok_len(tok: str) -> int:
    """Token length in UTF-8 bytes: the reference checks the Rust &str byte
    length (mod.rs:304), so a 25-letter Cyrillic token (50 bytes) is
    dropped at the 40-byte cut."""
    return len(tok) if tok.isascii() else len(tok.encode("utf-8"))


def count_tokens_plain(text: str, max_token_len: int = 40) -> int:
    """``count_tokens`` in Python."""
    n = 0
    for tok in tokenize(text):
        if _tok_len(tok) <= max_token_len and tok.lower() not in STOPWORDS:
            n += 1
    return n


def _term_counts(text: str, max_token_len: int) -> dict[int, int]:
    freq: dict[int, int] = {}
    for tok in tokenize(text):
        if _tok_len(tok) > max_token_len:
            continue
        lower = tok.lower()
        if lower in STOPWORDS:
            continue
        h = _stem_hash(lower)
        freq[h] = freq.get(h, 0) + 1
    return freq


def compute_bm25_tf(count: int, doc_len: int, avg_doc_len: float, k1: float, b: float) -> float:
    """BM25 tf with k1/b (tf_idf/mod.rs:362-371), in double precision."""
    return count * (k1 + 1.0) / (count + k1 * (1.0 - b + b * (doc_len / avg_doc_len)))


def process_text_plain(
    text: str,
    max_token_len: int = 40,
    avg_doc_len: float = 1.0,
    k1: float = 1.2,
    b: float = 0.75,
) -> list[tuple[int, float]]:
    """``process_text`` in Python."""
    doc_len = count_tokens_plain(text, max_token_len)
    return [
        (h, compute_bm25_tf(c, doc_len, avg_doc_len, k1, b))
        for h, c in _term_counts(text, max_token_len).items()
    ]


def process_text_query_plain(text: str, max_token_len: int = 40) -> list[int]:
    """``process_text_query`` in Python."""
    return list(_term_counts(text, max_token_len))
