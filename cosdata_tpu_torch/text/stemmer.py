"""Snowball English stemmer, written to give what nltk 3.10's
``SnowballStemmer("english").stem`` gives on every word.

The reference stems with nltk, which the port does not import, so this
module follows nltk's reading of the Porter2 algorithm where it departs
from the published text:

- the word is lowercased, and a word of at most two characters comes back
  as it is, before the special-word table is consulted;
- the three apostrophes U+2019, U+2018 and U+201B become ``'``, and one
  leading apostrophe is dropped;
- R1 after the prefixes ``gener``, ``arsen`` and ``commun`` is the rest of
  the word; R2 is then found inside that R1 from its second letter;
- the vowels are ``aeiouy``: every other character (``Y``, digits,
  non-ASCII letters) is a consonant;
- the regions R1 and R2 are carried as strings and trimmed with the word,
  with nltk's rules for a region shorter than the suffix (including the
  ``"e"`` that steps 2's ``ational``/``ation``/``ator`` and
  ``iveness``/``iviti`` leave in a short R2).

Pure Python; ``cosdata_tpu_torch/csrc/text_pipeline.cpp`` is its C++
reading in code points, which ``text/processing.py`` runs.
"""

from __future__ import annotations

_VOWELS = "aeiouy"
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = "cdeghkmnrt"
_STEP0 = ("'s'", "'s", "'")
_STEP1A = ("sses", "ied", "ies", "us", "ss", "s")
_STEP1B = ("eedly", "ingly", "edly", "eed", "ing", "ed")
_STEP2 = (
    "ization", "ational", "fulness", "ousness", "iveness", "tional", "biliti",
    "lessli", "entli", "ation", "alism", "aliti", "ousli", "iviti", "fulli",
    "enci", "anci", "abli", "izer", "ator", "alli", "bli", "ogi", "li",
)
#: step 2 suffix -> (replacement, R2 when R2 is shorter than the suffix)
_STEP2_REPLACE = {
    "izer": ("ize", ""), "ization": ("ize", ""),
    "ational": ("ate", "e"), "ation": ("ate", "e"), "ator": ("ate", "e"),
    "alism": ("al", ""), "aliti": ("al", ""), "alli": ("al", ""),
    "ousli": ("ous", ""), "ousness": ("ous", ""),
    "iveness": ("ive", "e"), "iviti": ("ive", "e"),
    "biliti": ("ble", ""), "bli": ("ble", ""),
}
_STEP3 = ("ational", "tional", "alize", "icate", "iciti", "ative", "ical", "ness", "ful")
_STEP4 = (
    "ement", "ance", "ence", "able", "ible", "ment", "ant", "ent", "ism", "ate",
    "iti", "ous", "ive", "ize", "ion", "al", "er", "ic",
)
_SPECIAL = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie", "tying": "tie",
    "idly": "idl", "gently": "gentl", "ugly": "ugli", "early": "earli", "only": "onli",
    "singly": "singl", "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes", "inning": "inning",
    "innings": "inning", "outing": "outing", "outings": "outing", "canning": "canning",
    "cannings": "canning", "herring": "herring", "herrings": "herring",
    "earring": "earring", "earrings": "earring", "proceed": "proceed",
    "proceeds": "proceed", "proceeded": "proceed", "proceeding": "proceed",
    "exceed": "exceed", "exceeds": "exceed", "exceeded": "exceed", "exceeding": "exceed",
    "succeed": "succeed", "succeeds": "succeed", "succeeded": "succeed",
    "succeeding": "succeed",
}


def _region_after(s: str) -> str:
    """The part of ``s`` after its first non-vowel that follows a vowel,
    looking from the second letter on ("" if there is none)."""
    for i in range(1, len(s)):
        if s[i] not in _VOWELS and s[i - 1] in _VOWELS:
            return s[i + 1 :]
    return ""


def _has_vowel(s: str) -> bool:
    return any(c in _VOWELS for c in s)


class _Word:
    """The word and its regions R1 and R2, trimmed together."""

    __slots__ = ("w", "r1", "r2")

    def __init__(self, w: str, r1: str, r2: str):
        self.w, self.r1, self.r2 = w, r1, r2

    def cut(self, n: int) -> None:
        """Drop the last ``n`` characters of the word and of each region
        (a region shorter than ``n`` becomes empty)."""
        self.w, self.r1, self.r2 = self.w[:-n], self.r1[:-n], self.r2[:-n]

    def replace(self, suffix: str, new: str, short_r2: str = "") -> None:
        """Replace ``suffix`` by ``new``; a region shorter than the suffix
        becomes "" (R2: ``short_r2``)."""
        n = len(suffix)
        self.w = self.w[:-n] + new
        self.r1 = self.r1[:-n] + new if len(self.r1) >= n else ""
        self.r2 = self.r2[:-n] + new if len(self.r2) >= n else short_r2


def _step1a(x: _Word) -> None:
    for suffix in _STEP1A:
        if not x.w.endswith(suffix):
            continue
        if suffix == "sses":
            x.cut(2)
        elif suffix in ("ied", "ies"):
            x.cut(2 if len(x.w) - 3 > 1 else 1)
        elif suffix == "s" and _has_vowel(x.w[:-2]):
            x.cut(1)
        return


def _step1b(x: _Word) -> None:
    for suffix in _STEP1B:
        if not x.w.endswith(suffix):
            continue
        if suffix in ("eed", "eedly"):
            if x.r1.endswith(suffix):
                x.replace(suffix, "ee")
            return
        if not _has_vowel(x.w[: -len(suffix)]):
            return
        x.cut(len(suffix))
        w = x.w
        if w.endswith(("at", "bl", "iz")):
            x.w += "e"
            x.r1 += "e"
            if len(x.w) > 5 or len(x.r1) >= 3:
                x.r2 += "e"
        elif w.endswith(_DOUBLES):
            x.cut(1)
        elif x.r1 == "" and (
            (len(w) >= 3 and w[-1] not in _VOWELS and w[-1] not in "wxY"
             and w[-2] in _VOWELS and w[-3] not in _VOWELS)
            or (len(w) == 2 and w[0] in _VOWELS and w[1] not in _VOWELS)
        ):
            # a short word: R1 is empty, so only the word grows
            x.w += "e"
        return


def _step2(x: _Word) -> None:
    for suffix in _STEP2:
        if not x.w.endswith(suffix):
            continue
        if not x.r1.endswith(suffix):
            return
        if suffix in ("tional", "entli", "fulli", "lessli"):
            x.cut(2)
        elif suffix in ("enci", "anci", "abli"):
            # nltk trims the regions by the final i alone
            x.replace("i", "e")
        elif suffix == "fulness":
            x.cut(4)
        elif suffix == "ogi":
            if x.w[-4] == "l":
                x.cut(1)
        elif suffix == "li":
            if x.w[-3] in _LI_ENDING:
                x.cut(2)
        else:
            new, short_r2 = _STEP2_REPLACE[suffix]
            x.replace(suffix, new, short_r2)
        return


def _step3(x: _Word) -> None:
    for suffix in _STEP3:
        if not x.w.endswith(suffix):
            continue
        if not x.r1.endswith(suffix):
            return
        if suffix == "tional":
            x.cut(2)
        elif suffix == "ational":
            x.replace(suffix, "ate")
        elif suffix == "alize":
            x.cut(3)
        elif suffix in ("icate", "iciti", "ical"):
            x.replace(suffix, "ic")
        elif suffix in ("ful", "ness"):
            x.cut(len(suffix))
        elif suffix == "ative" and x.r2.endswith(suffix):
            x.cut(5)
        return


def _step4(x: _Word) -> None:
    for suffix in _STEP4:
        if not x.w.endswith(suffix):
            continue
        if x.r2.endswith(suffix):
            if suffix != "ion":
                x.cut(len(suffix))
            elif x.w[-4] in "st":
                x.cut(3)
        return


def _step5(x: _Word) -> None:
    w = x.w
    if x.r2.endswith("l") and w[-2] == "l":
        x.w = w[:-1]
    elif x.r2.endswith("e"):
        x.w = w[:-1]
    elif x.r1.endswith("e") and len(w) >= 4 and (
        w[-2] in _VOWELS or w[-2] in "wxY" or w[-3] not in _VOWELS or w[-4] in _VOWELS
    ):
        x.w = w[:-1]


def stem(word: str) -> str:
    """The Snowball English stem of ``word`` (lowercased first)."""
    word = word.lower()
    if len(word) <= 2:
        return word
    if word in _SPECIAL:
        return _SPECIAL[word]
    word = word.replace("\u2019", "'").replace("\u2018", "'").replace("\u201b", "'")
    if word.startswith("'"):
        word = word[1:]
    if word.startswith("y"):
        word = "Y" + word[1:]
    # y after a vowel is a consonant: mark it, left to right (a marked Y is
    # no vowel, so "ayy" gives "aYy")
    chars = list(word)
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    word = "".join(chars)
    if word.startswith(("gener", "arsen")):
        r1 = word[5:]
    elif word.startswith("commun"):
        r1 = word[6:]
    else:
        r1 = _region_after(word)
    x = _Word(word, r1, _region_after(r1))
    for suffix in _STEP0:
        if x.w.endswith(suffix):
            x.cut(len(suffix))
            break
    _step1a(x)
    _step1b(x)
    # step 1c: a final y or Y after a non-vowel (not the first letter) -> i
    if len(x.w) > 2 and x.w[-1] in "yY" and x.w[-2] not in _VOWELS:
        x.replace(x.w[-1], "i")
    _step2(x)
    _step3(x)
    _step4(x)
    _step5(x)
    return x.w.replace("Y", "y")
