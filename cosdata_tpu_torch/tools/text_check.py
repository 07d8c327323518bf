"""The native text pipeline held against its plain Python version, and the
inputs both are held on. Used by ``chip_smoke.py`` (phase 16, on the card
machine's own interpreter) and by ``tests/test_torch_text_native.py``.

"Equal" is bit for bit: the term ids in their order, the document length
and each tf as a double, for ``process_text``, ``count_tokens`` and
``process_text_query``.
"""

from __future__ import annotations

import numpy as np

from cosdata_tpu_torch.text import processing as TP

#: one case per line: a dotted capital I (lowers to two code points), final
#: sigmas, sharp s, ligatures, combining marks beside precomposed letters,
#: Arabic-Indic, Devanagari and fullwidth digits, CJK, emoji, the 40-byte
#: cut (21 Cyrillic letters are 42 bytes, 20 are 40), an embedded NUL, lone
#: surrogates and the empty string
UNICODE_CORPUS = [
    "İstanbul İSTANBUL istanbul",
    "ΟΔΟΣ ΣΑΣ Σ",
    "ὈΔΥΣΣΕΎΣ ΣΊΣΥΦΟΣ ΑΣͅ Σ_Α Σ1 aΣ",
    "Straße STRASSE ẞ",
    "ﬁnance ﬂying ﬃ",
    "e\u0301te\u0301 cafe\u0301 nai\u0308ve n\u0303o \u1fb3 \u00e9t\u00e9 caf\u00e9",
    "١٢٣ ٤٥ ४२ ４５６ ｗｏｒｄｓ Ｗ１",
    "東京は日本の首都です 北京 서울특별시",
    "😀 smile😀face 👍🏽 ok🙂running",
    "ж" * 21 + " " + "ж" * 20 + " " + "ж" * 19 + "z",
    "nul\x00byte\x00 here\x00",
    "lone\ud800surrogate \udfff end\U0010fc00x",
    "",
]


def bm25_corpus(n_docs: int, vocab: int = 20_000, words: int = 40, seed: int = 9) -> tuple[list[str], np.ndarray]:
    """``bench.py``'s BM25 corpus (phase 16's): words w0 .. w{vocab-1},
    pareto(1.1) ids mod the vocabulary, ``words`` per document; returns the
    texts and the (n_docs, words) word ids."""
    rng = np.random.default_rng(seed)
    ids = (rng.pareto(1.1, size=n_docs * words).astype(np.int64) % vocab).reshape(n_docs, words)
    names = [f"w{i}" for i in range(vocab)]
    return [" ".join(names[w] for w in row) for row in ids.tolist()], ids


def pipeline(texts, plain: bool, max_token_len: int = 40, avg_doc_len: float = 7.0, k1: float = 1.2,
             b: float = 0.75) -> list[tuple]:
    """Each text's ``process_text`` (each tf as its hex digits), ``count_tokens``
    and ``process_text_query``, by the plain version or by the library."""
    fns = (
        (TP.process_text_plain, TP.count_tokens_plain, TP.process_text_query_plain)
        if plain else (TP.process_text, TP.count_tokens, TP.process_text_query)
    )
    process, count, query = fns
    return [
        (
            [(h, tf.hex()) for h, tf in process(text, max_token_len, avg_doc_len, k1, b)],
            count(text, max_token_len),
            query(text, max_token_len),
        )
        for text in texts
    ]


def differences(texts, max_token_len: int = 40, avg_doc_len: float = 7.0, k1: float = 1.2,
                b: float = 0.75) -> list[int]:
    """Indexes of the texts on which the library and the plain version differ."""
    lib = pipeline(texts, False, max_token_len, avg_doc_len, k1, b)
    plain = pipeline(texts, True, max_token_len, avg_doc_len, k1, b)
    return [i for i, (a, c) in enumerate(zip(lib, plain)) if a != c]
