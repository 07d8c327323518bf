"""The port's text pipeline (cosdata_tpu_torch/text/) against the
reference's (cosdata_tpu/text/processing.py) and nltk 3.10.

- The port's Snowball stemmer gives nltk's ``SnowballStemmer("english")
  .stem`` on every distinct ``\\w+`` token (lowercased) of the
  repository's own ``*.py`` and ``*.md`` files, on nltk's special words
  and the rules around them, and on hypothesis-drawn ASCII and non-ASCII
  words.
- ``process_text``, ``process_text_query`` and ``count_tokens`` give the
  reference's answers on both of its paths (its Python path with
  ``_native`` forced to None, and its native ASCII path where ``_native.so``
  is built): the same term ids, tfs at rtol 1e-6 (the port computes the
  tf in double precision, as the reference's Python path does; the native
  path computes in f32).
- A subprocess that imports the port's text pipeline and tf-idf index
  holds no ``nltk``, ``jax`` or ``cosdata_tpu`` module.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from nltk.stem.snowball import SnowballStemmer

from cosdata_tpu.text import processing as JP
from cosdata_tpu_torch.text import processing as TP
from cosdata_tpu_torch.text.stemmer import stem

ROOT = Path(__file__).resolve().parents[1]
NLTK = SnowballStemmer("english")

#: nltk's special-word table, its step-1a exceptions, the gener/commun/arsen
#: prefixes, y marking, apostrophes, the two-letter early return and words
#: with non-ASCII letters (consonants to nltk)
SPECIAL = [
    "skis", "skies", "dying", "lying", "tying", "idly", "gently", "ugly", "early", "only",
    "singly", "sky", "news", "howe", "atlas", "cosmos", "bias", "andes", "inning", "innings",
    "outing", "outings", "canning", "cannings", "herring", "herrings", "earring", "earrings",
    "proceed", "proceeds", "proceeded", "proceeding", "exceed", "exceeds", "exceeded",
    "exceeding", "succeed", "succeeds", "succeeded", "succeeding", "generate", "generously",
    "communism", "communication", "arsenic", "arsenal", "youth", "yay", "boyish", "enjoying",
    "sayings", "ayy", "'tis", "dog's", "dogs'", "o'neill", "rock’n’roll", "‘quoted’",
    "it‛s", "is", "as", "us", "a", "", "ties", "cries", "lies", "caresses", "gas", "this",
    "feed", "agreed", "disagreedly", "luxuriating", "hopping", "hoping", "filing", "failing",
    "conditional", "rational", "valency", "hesitancy", "digitizer", "operator", "feudalism",
    "decisiveness", "hopefulness", "callousness", "formaliti", "sensibiliti", "analogi",
    "geologi", "fluentli", "brightli", "triplicate", "formative", "formalize", "electriciti",
    "electrical", "hopeful", "goodness", "revival", "allowance", "inference", "airliner",
    "gyroscopic", "adjustable", "defensible", "irritant", "replacement", "adjustment",
    "dependent", "adoption", "communion", "activate", "angulariti", "homologous", "effective",
    "bowdlerize", "probate", "rate", "cease", "controll", "roll", "naïve", "café", "façade",
    "résumé", "straße", "jalapeños", "œuvre", "ÿes", "ʼapostrophe", "ﬁne", "İstanbul",
    "sıkıştırma", "привет", "наблюдения", "東京", "x86_64", "a_token_with_underscores",
    "42nd", "w123", "w1", "ye", "yes", "eyes", "bye", "flyer",
]


def _repo_words() -> set[str]:
    words = set()
    for pattern in ("*.py", "*.md"):
        for p in ROOT.rglob(pattern):
            if any(part.startswith(".") or part in ("checkouts", "chiprun_out") for part in p.parts):
                continue
            words |= {w.lower() for w in re.findall(r"\w+", p.read_text(errors="ignore"))}
    return words


def test_stemmer_matches_nltk_on_the_repository_words():
    words = _repo_words()
    assert len(words) > 5_000
    bad = [(w, stem(w), NLTK.stem(w)) for w in sorted(words) if stem(w) != NLTK.stem(w)]
    assert not bad, bad[:20]


@pytest.mark.parametrize("word", SPECIAL)
def test_stemmer_matches_nltk_on_special_words(word):
    assert stem(word) == NLTK.stem(word)


@settings(max_examples=3000, deadline=None, database=None)
@given(st.text(alphabet="abcdefghijklmnopqrstuvwxyzY'", min_size=0, max_size=16))
def test_stemmer_matches_nltk_on_ascii_words(word):
    assert stem(word) == NLTK.stem(word)


@settings(max_examples=3000, deadline=None, database=None)
@given(st.text(alphabet=st.sampled_from(list("aeiouylnrstcgbd'") + list("éñüøßяжıİ’‘‛東")),
               min_size=0, max_size=14))
def test_stemmer_matches_nltk_on_non_ascii_words(word):
    assert stem(word) == NLTK.stem(word)


DOCS = [
    "The quick brown fox jumps over the lazy dog",
    "generalization of internationalization strategies",
    "running runs runner ran; dying lying tying skies skis",
    "a_token_with_underscores and numbers like 42 or x86_64",
    "conditional rationalization of sensational electrical traditions",
    "'quoted' words and trailing apostrophes' here",
    "Café naïve résumé — jalapeños straße; привет мир наблюдения",
    "repeated repeated REPEATED words words with WITH the THE stopwords",
    "",
    "a an the of",
    "supercalifragilisticexpialidocious_is_a_very_long_token_indeed and short",
]


def _reference_paths():
    paths = ["python"]
    if JP._native is not None:
        paths.append("native")
    return paths


@pytest.mark.parametrize("path", _reference_paths())
@pytest.mark.parametrize("doc", DOCS)
def test_process_text_matches_reference(doc, path, monkeypatch):
    if path == "python":
        monkeypatch.setattr(JP, "_native", None)
    for avgdl, k1, b in ((7.0, 1.2, 0.75), (3.5, 2.0, 0.3)):
        got = dict(TP.process_text(doc, 40, avgdl, k1, b))
        want = dict(JP.process_text(doc, 40, avgdl, k1, b))
        assert set(got) == set(want)
        for h in want:
            assert got[h] == pytest.approx(want[h], rel=1e-6)
            if path == "python":
                assert got[h] == want[h]  # the same double-precision arithmetic
    assert TP.count_tokens(doc) == JP.count_tokens(doc)
    assert TP.process_text_query(doc) == JP.process_text_query(doc)
    assert TP.tokenize(doc) == JP.tokenize(doc)
    assert TP.STOPWORDS == JP.STOPWORDS and len(TP.STOPWORDS) == 35


def test_byte_length_cut_drops_a_long_cyrillic_token():
    """25 Cyrillic letters are 50 UTF-8 bytes: past the 40-byte cut in both
    packages, while 25 ASCII letters are kept."""
    cyr, ascii_word = "ж" * 25, "z" * 25
    text = f"{cyr} {ascii_word} мир"
    for pkg in (TP, JP):
        assert pkg.count_tokens(text, 40) == 2
        assert len(pkg.process_text(text, 40, 2.0)) == 2
        assert pkg._tok_len(cyr) == 50
    assert TP.process_text_query(text) == JP.process_text_query(text)


def test_port_imports_no_nltk_jax_or_reference():
    code = (
        "import sys\n"
        "import cosdata_tpu_torch.text.processing, cosdata_tpu_torch.indexes.tf_idf\n"
        "from cosdata_tpu_torch.indexes.tf_idf import TFIDFIndex\n"
        "t = TFIDFIndex('cpu', sample_threshold=2)\n"
        "t.add(0, 'hello world'); t.add(1, 'worlds apart')\n"
        "assert sorted(t.search(['world'], 2)[0][0].tolist()) == [0, 1]\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('nltk', 'jax', 'jaxlib', 'cosdata_tpu'))\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
