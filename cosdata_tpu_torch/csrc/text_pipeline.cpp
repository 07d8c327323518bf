// The BM25 text pipeline of the port, in one call per text: tokenize ->
// lowercase -> stopword filter -> Snowball English stem -> xxhash32 term id
// -> BM25 term frequency.
//
// It computes what the plain Python pipeline (text/processing.py, with its
// stemmer text/stemmer.py) computes, on every input:
//
// - the text arrives as UTF-8 with an explicit length (lone surrogates
//   encoded as three bytes, "surrogatepass"), so an embedded NUL is a
//   character like any other;
// - a token is a run of code points that are str.isalnum() or '_' (what
//   re's \w matches on a str);
// - the 40-byte cut is on the UTF-8 length of the original token; the
//   stopword check and the stem then work on its str.lower(), with the
//   Final_Sigma context of CPython's str.lower();
// - the stemmer works in code points: a word of at most two code points
//   comes back unchanged, every non-ASCII character is a consonant, R1 and
//   R2 are measured in code points, and the term id is
//   xxh32(stem.encode("utf-8"), seed=0);
// - the tf is the Python expression's double arithmetic in its operation
//   order (built with -ffp-contract=off, so no multiply-add is fused);
// - terms keep their first occurrence's order, as a Python dict does.
//
// The Unicode tables are not in this file: text/native.py generates them
// from the building interpreter's str methods and passes them with
// -include (TP_WORD, TP_LOWER, TP_LOWER_MULTI, TP_IGNORABLE, TP_CASED).
//
// Reentrant: the outputs, the stem cache and the scratch buffers belong
// to the caller (TpOut, one per thread).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#ifndef TP_TABLES
#error "text_pipeline.cpp needs the generated Unicode tables (-include <header>, see text/native.py)"
#endif

// ---------------------------------------------------------------- xxhash32

static const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                      P4 = 668265263u, P5 = 374761393u;

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

static inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // little-endian hosts (x86-64, aarch64)
}

static uint32_t xxh32(const uint8_t* input, size_t len, uint32_t seed) {
  const uint8_t* p = input;
  const uint8_t* end = input + len;
  uint32_t h;
  if (len >= 16) {
    uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl32(v1 + read32(p) * P2, 13) * P1; p += 4;
      v2 = rotl32(v2 + read32(p) * P2, 13) * P1; p += 4;
      v3 = rotl32(v3 + read32(p) * P2, 13) * P1; p += 4;
      v4 = rotl32(v4 + read32(p) * P2, 13) * P1; p += 4;
    } while (p <= limit);
    h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
  } else {
    h = seed + P5;
  }
  h += (uint32_t)len;
  while (p + 4 <= end) {
    h = rotl32(h + read32(p) * P3, 17) * P4;
    p += 4;
  }
  while (p < end) {
    h = rotl32(h + (*p) * P5, 11) * P1;
    ++p;
  }
  h ^= h >> 15; h *= P2; h ^= h >> 13; h *= P3; h ^= h >> 16;
  return h;
}

// ------------------------------------------------------------ Unicode

using U32 = std::u32string;

template <size_t N>
static bool in_ranges(const uint32_t (&r)[N][2], char32_t c) {
  // r is sorted by its first column and its ranges do not overlap
  size_t lo = 0, hi = N;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (r[mid][1] < (uint32_t)c) lo = mid + 1; else hi = mid;
  }
  return lo < N && r[lo][0] <= (uint32_t)c;
}

static inline bool is_word(char32_t c) {
  if (c < 0x80)
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || (c >= '0' && c <= '9') || c == '_';
  return in_ranges(TP_WORD, c);
}

// CPython's handle_capital_sigma, over the token (the string str.lower() sees)
static bool final_sigma(const U32& tok, size_t i) {
  long j = (long)i - 1;
  while (j >= 0 && in_ranges(TP_IGNORABLE, tok[j])) j--;
  bool fin = j >= 0 && in_ranges(TP_CASED, tok[j]);
  if (fin && i + 1 < tok.size()) {
    size_t k = i + 1;
    while (k < tok.size() && in_ranges(TP_IGNORABLE, tok[k])) k++;
    fin = k == tok.size() || !in_ranges(TP_CASED, tok[k]);
  }
  return fin;
}

// str.lower() of a token of word characters
static void lower_token(const U32& tok, U32& out) {
  out.clear();
  for (size_t i = 0; i < tok.size(); i++) {
    char32_t c = tok[i];
    if (c < 0x80) {
      out.push_back((c >= 'A' && c <= 'Z') ? c + 32 : c);
      continue;
    }
    if (c == 0x3A3) {
      out.push_back(final_sigma(tok, i) ? 0x3C2 : 0x3C3);
      continue;
    }
    const uint32_t(*m)[5] = std::lower_bound(
        std::begin(TP_LOWER_MULTI), std::end(TP_LOWER_MULTI), (uint32_t)c,
        [](const uint32_t(&e)[5], uint32_t v) { return e[0] < v; });
    if (m != std::end(TP_LOWER_MULTI) && (*m)[0] == (uint32_t)c) {
      for (uint32_t k = 0; k < (*m)[1]; k++) out.push_back((*m)[2 + k]);
      continue;
    }
    const uint32_t(*s)[2] = std::lower_bound(
        std::begin(TP_LOWER), std::end(TP_LOWER), (uint32_t)c,
        [](const uint32_t(&e)[2], uint32_t v) { return e[0] < v; });
    out.push_back((s != std::end(TP_LOWER) && (*s)[0] == (uint32_t)c) ? (char32_t)(*s)[1] : c);
  }
}

static void utf8_append(std::string& out, char32_t c) {
  if (c < 0x80) {
    out.push_back((char)c);
  } else if (c < 0x800) {
    out.push_back((char)(0xC0 | (c >> 6)));
    out.push_back((char)(0x80 | (c & 0x3F)));
  } else if (c < 0x10000) {
    out.push_back((char)(0xE0 | (c >> 12)));
    out.push_back((char)(0x80 | ((c >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (c & 0x3F)));
  } else {
    out.push_back((char)(0xF0 | (c >> 18)));
    out.push_back((char)(0x80 | ((c >> 12) & 0x3F)));
    out.push_back((char)(0x80 | ((c >> 6) & 0x3F)));
    out.push_back((char)(0x80 | (c & 0x3F)));
  }
}

// ------------------------------------------------------ Snowball English
// text/stemmer.py line for line, in code points: the vowels are "aeiouy",
// every other code point is a consonant, and the regions R1 and R2 are
// carried as strings trimmed with the word.

namespace porter2 {

static inline bool vowel(char32_t c) {
  return c == 'a' || c == 'e' || c == 'i' || c == 'o' || c == 'u' || c == 'y';
}

static bool ends_with(const U32& s, const char* suf) {
  size_t n = std::strlen(suf);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; i++)
    if (s[s.size() - n + i] != (char32_t)(unsigned char)suf[i]) return false;
  return true;
}

static bool starts_with(const U32& s, const char* pre) {
  size_t n = std::strlen(pre);
  if (s.size() < n) return false;
  for (size_t i = 0; i < n; i++)
    if (s[i] != (char32_t)(unsigned char)pre[i]) return false;
  return true;
}

static bool is_one_of(char32_t c, const char* set) {
  for (; *set; set++)
    if (c == (char32_t)(unsigned char)*set) return true;
  return false;
}

static void append(U32& s, const char* a) {
  for (; *a; a++) s.push_back((char32_t)(unsigned char)*a);
}

// s[:-n] (empty when s is shorter)
static void chop(U32& s, size_t n) { s.erase(s.size() > n ? s.size() - n : 0); }

// the part of s after its first non-vowel that follows a vowel
static U32 region_after(const U32& s) {
  for (size_t i = 1; i < s.size(); i++)
    if (!vowel(s[i]) && vowel(s[i - 1])) return s.substr(i + 1);
  return U32();
}

// any vowel in s[:-n]
static bool has_vowel_before(const U32& s, size_t n) {
  size_t end = s.size() > n ? s.size() - n : 0;
  for (size_t i = 0; i < end; i++)
    if (vowel(s[i])) return true;
  return false;
}

struct Word {
  U32 w, r1, r2;

  void cut(size_t n) { chop(w, n); chop(r1, n); chop(r2, n); }

  // replace a suffix of n code points by rep; a region shorter than the
  // suffix becomes "" (R2: short_r2)
  void replace(size_t n, const char* rep, const char* short_r2 = "") {
    chop(w, n);
    append(w, rep);
    if (r1.size() >= n) { chop(r1, n); append(r1, rep); } else { r1.clear(); }
    if (r2.size() >= n) { chop(r2, n); append(r2, rep); } else { r2.clear(); append(r2, short_r2); }
  }

  // w[-k] (0 where the word is shorter: no branch below reads past it)
  char32_t back(size_t k) const { return w.size() >= k ? w[w.size() - k] : 0; }
};

static const char* const kDoubles[] = {"bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt"};

static void step1a(Word& x) {
  for (const char* suf : {"sses", "ied", "ies", "us", "ss", "s"}) {
    if (!ends_with(x.w, suf)) continue;
    if (!std::strcmp(suf, "sses")) {
      x.cut(2);
    } else if (!std::strcmp(suf, "ied") || !std::strcmp(suf, "ies")) {
      x.cut((long)x.w.size() - 3 > 1 ? 2 : 1);
    } else if (!std::strcmp(suf, "s") && has_vowel_before(x.w, 2)) {
      x.cut(1);
    }
    return;
  }
}

static void step1b(Word& x) {
  for (const char* suf : {"eedly", "ingly", "edly", "eed", "ing", "ed"}) {
    if (!ends_with(x.w, suf)) continue;
    size_t n = std::strlen(suf);
    if (!std::strcmp(suf, "eed") || !std::strcmp(suf, "eedly")) {
      if (ends_with(x.r1, suf)) x.replace(n, "ee");
      return;
    }
    if (!has_vowel_before(x.w, n)) return;
    x.cut(n);
    const U32& w = x.w;
    bool dbl = false;
    for (const char* d : kDoubles) dbl = dbl || ends_with(w, d);
    if (ends_with(w, "at") || ends_with(w, "bl") || ends_with(w, "iz")) {
      x.w.push_back('e');
      x.r1.push_back('e');
      if (x.w.size() > 5 || x.r1.size() >= 3) x.r2.push_back('e');
    } else if (dbl) {
      x.cut(1);
    } else if (x.r1.empty() &&
               ((w.size() >= 3 && !vowel(x.back(1)) && !is_one_of(x.back(1), "wxY") && vowel(x.back(2)) &&
                 !vowel(x.back(3))) ||
                (w.size() == 2 && vowel(w[0]) && !vowel(w[1])))) {
      x.w.push_back('e');  // a short word: R1 is empty, so only the word grows
    }
    return;
  }
}

static void step2(Word& x) {
  static const char* const sufs[] = {
      "ization", "ational", "fulness", "ousness", "iveness", "tional", "biliti", "lessli",
      "entli",   "ation",   "alism",   "aliti",   "ousli",   "iviti",  "fulli",  "enci",
      "anci",    "abli",    "izer",    "ator",    "alli",    "bli",    "ogi",    "li",
  };
  // suffix -> (replacement, R2 when R2 is shorter than the suffix)
  static const char* const repl[][3] = {
      {"izer", "ize", ""},     {"ization", "ize", ""}, {"ational", "ate", "e"}, {"ation", "ate", "e"},
      {"ator", "ate", "e"},    {"alism", "al", ""},    {"aliti", "al", ""},     {"alli", "al", ""},
      {"ousli", "ous", ""},    {"ousness", "ous", ""}, {"iveness", "ive", "e"}, {"iviti", "ive", "e"},
      {"biliti", "ble", ""},   {"bli", "ble", ""},
  };
  for (const char* suf : sufs) {
    if (!ends_with(x.w, suf)) continue;
    if (!ends_with(x.r1, suf)) return;
    std::string s = suf;
    if (s == "tional" || s == "entli" || s == "fulli" || s == "lessli") {
      x.cut(2);
    } else if (s == "enci" || s == "anci" || s == "abli") {
      x.replace(1, "e");  // nltk trims the regions by the final i alone
    } else if (s == "fulness") {
      x.cut(4);
    } else if (s == "ogi") {
      if (x.back(4) == 'l') x.cut(1);
    } else if (s == "li") {
      if (is_one_of(x.back(3), "cdeghkmnrt")) x.cut(2);
    } else {
      for (const auto& r : repl)
        if (s == r[0]) x.replace(s.size(), r[1], r[2]);
    }
    return;
  }
}

static void step3(Word& x) {
  for (const char* suf : {"ational", "tional", "alize", "icate", "iciti", "ative", "ical", "ness", "ful"}) {
    if (!ends_with(x.w, suf)) continue;
    if (!ends_with(x.r1, suf)) return;
    std::string s = suf;
    if (s == "tional") {
      x.cut(2);
    } else if (s == "ational") {
      x.replace(s.size(), "ate");
    } else if (s == "alize") {
      x.cut(3);
    } else if (s == "icate" || s == "iciti" || s == "ical") {
      x.replace(s.size(), "ic");
    } else if (s == "ful" || s == "ness") {
      x.cut(s.size());
    } else if (s == "ative" && ends_with(x.r2, suf)) {
      x.cut(5);
    }
    return;
  }
}

static void step4(Word& x) {
  for (const char* suf : {"ement", "ance", "ence", "able", "ible", "ment", "ant", "ent", "ism", "ate", "iti",
                          "ous", "ive", "ize", "ion", "al", "er", "ic"}) {
    if (!ends_with(x.w, suf)) continue;
    if (ends_with(x.r2, suf)) {
      if (std::strcmp(suf, "ion")) {
        x.cut(std::strlen(suf));
      } else if (is_one_of(x.back(4), "st")) {
        x.cut(3);
      }
    }
    return;
  }
}

static void step5(Word& x) {
  if (ends_with(x.r2, "l") && x.back(2) == 'l') {
    chop(x.w, 1);
  } else if (ends_with(x.r2, "e")) {
    chop(x.w, 1);
  } else if (ends_with(x.r1, "e") && x.w.size() >= 4 &&
             (vowel(x.back(2)) || is_one_of(x.back(2), "wxY") || !vowel(x.back(3)) || vowel(x.back(4)))) {
    chop(x.w, 1);
  }
}

static const std::unordered_map<std::string, const char*>& special_words() {
  static const std::unordered_map<std::string, const char*> m = {
      {"skis", "ski"},         {"skies", "sky"},         {"dying", "die"},          {"lying", "lie"},
      {"tying", "tie"},        {"idly", "idl"},          {"gently", "gentl"},       {"ugly", "ugli"},
      {"early", "earli"},      {"only", "onli"},         {"singly", "singl"},       {"sky", "sky"},
      {"news", "news"},        {"howe", "howe"},         {"atlas", "atlas"},        {"cosmos", "cosmos"},
      {"bias", "bias"},        {"andes", "andes"},       {"inning", "inning"},      {"innings", "inning"},
      {"outing", "outing"},    {"outings", "outing"},    {"canning", "canning"},    {"cannings", "canning"},
      {"herring", "herring"},  {"herrings", "herring"},  {"earring", "earring"},    {"earrings", "earring"},
      {"proceed", "proceed"},  {"proceeds", "proceed"},  {"proceeded", "proceed"},  {"proceeding", "proceed"},
      {"exceed", "exceed"},    {"exceeds", "exceed"},    {"exceeded", "exceed"},    {"exceeding", "exceed"},
      {"succeed", "succeed"},  {"succeeds", "succeed"},  {"succeeded", "succeed"},  {"succeeding", "succeed"},
  };
  return m;
}

// the stem of a lowercased word (str.lower() is idempotent on it: the
// table generator checks that, so stemmer.py's own lower() is not repeated)
static U32 stem(U32 word) {
  if (word.size() <= 2) return word;
  if (word.size() <= 10) {
    std::string ascii;
    bool is_ascii = true;
    for (char32_t c : word) {
      if (c >= 0x80) { is_ascii = false; break; }
      ascii.push_back((char)c);
    }
    if (is_ascii) {
      auto sp = special_words().find(ascii);
      if (sp != special_words().end()) {
        U32 out;
        append(out, sp->second);
        return out;
      }
    }
  }
  for (char32_t& c : word)
    if (c == 0x2019 || c == 0x2018 || c == 0x201B) c = '\'';
  if (!word.empty() && word[0] == '\'') word.erase(0, 1);
  if (!word.empty() && word[0] == 'y') word[0] = 'Y';
  // y after a vowel is a consonant: mark it, left to right
  for (size_t i = 1; i < word.size(); i++)
    if (word[i] == 'y' && vowel(word[i - 1])) word[i] = 'Y';
  U32 r1;
  if (starts_with(word, "gener") || starts_with(word, "arsen"))
    r1 = word.substr(5);
  else if (starts_with(word, "commun"))
    r1 = word.substr(6);
  else
    r1 = region_after(word);
  Word x{word, r1, region_after(r1)};
  for (const char* suf : {"'s'", "'s", "'"}) {
    if (ends_with(x.w, suf)) {
      x.cut(std::strlen(suf));
      break;
    }
  }
  step1a(x);
  step1b(x);
  // step 1c: a final y or Y after a non-vowel (not the first letter) -> i
  if (x.w.size() > 2 && (x.back(1) == 'y' || x.back(1) == 'Y') && !vowel(x.back(2))) x.replace(1, "i");
  step2(x);
  step3(x);
  step4(x);
  step5(x);
  for (char32_t& c : x.w)
    if (c == 'Y') c = 'y';
  return x.w;
}

}  // namespace porter2

// ---------------------------------------------------------------- pipeline

// an ASCII word of at most 8 letters as one integer, first letter lowest
static constexpr uint64_t pack(const char* w) {
  uint64_t v = 0;
  for (int i = 0; w[i]; i++) v |= (uint64_t)(unsigned char)w[i] << (8 * i);
  return v;
}

static bool is_stopword(const U32& w) {
  // tf_idf/mod.rs:282-286 of the upstream project
  static constexpr uint64_t words[] = {
      pack("a"),    pack("and"),  pack("are"),   pack("as"),    pack("at"),   pack("be"),    pack("but"),
      pack("by"),   pack("for"),  pack("if"),    pack("in"),    pack("into"), pack("is"),    pack("it"),
      pack("no"),   pack("not"),  pack("of"),    pack("on"),    pack("or"),   pack("s"),     pack("such"),
      pack("t"),    pack("that"), pack("the"),   pack("their"), pack("then"), pack("there"), pack("these"),
      pack("they"), pack("this"), pack("to"),    pack("was"),   pack("will"), pack("with"),  pack("www"),
  };
  if (w.size() > 5) return false;
  uint64_t v = 0;
  for (size_t i = 0; i < w.size(); i++) {
    if (w[i] >= 0x80) return false;
    v |= (uint64_t)w[i] << (8 * i);
  }
  for (uint64_t s : words)
    if (s == v) return true;
  return false;
}

namespace {

// the caller's pipeline state: the stem cache (lowered token -> term id)
// and the current text's terms in first-occurrence order
struct State {
  std::unordered_map<std::string, uint32_t> stems;
  U32 tok, lowered;
  std::string key, stem_utf8;
  std::vector<uint32_t> ids;
  std::vector<int64_t> counts;
  std::vector<int32_t> slots;  // open addressing over ids: index + 1, 0 empty
};

constexpr size_t kStemCacheMax = 1 << 18;

uint32_t term_id(State& s) {
  s.key.clear();
  for (char32_t c : s.lowered) utf8_append(s.key, c);
  auto hit = s.stems.find(s.key);
  if (hit != s.stems.end()) return hit->second;
  U32 st = porter2::stem(s.lowered);
  s.stem_utf8.clear();
  for (char32_t c : st) utf8_append(s.stem_utf8, c);
  uint32_t h = xxh32((const uint8_t*)s.stem_utf8.data(), s.stem_utf8.size(), 0);
  if (s.stems.size() >= kStemCacheMax) s.stems.clear();
  s.stems.emplace(s.key, h);
  return h;
}

void count_term(State& s, uint32_t h) {
  if (2 * (s.ids.size() + 1) > s.slots.size()) {  // keep the table at most half full
    s.slots.assign(std::max<size_t>(64, 4 * s.slots.size()), 0);
    size_t mask = s.slots.size() - 1;
    for (size_t t = 0; t < s.ids.size(); t++) {
      size_t p = s.ids[t] & mask;
      while (s.slots[p]) p = (p + 1) & mask;
      s.slots[p] = (int32_t)t + 1;
    }
  }
  size_t mask = s.slots.size() - 1;
  size_t p = h & mask;
  while (s.slots[p]) {
    int32_t t = s.slots[p] - 1;
    if (s.ids[t] == h) {
      s.counts[t]++;
      return;
    }
    p = (p + 1) & mask;
  }
  s.slots[p] = (int32_t)s.ids.size() + 1;
  s.ids.push_back(h);
  s.counts.push_back(1);
}

// one code point of well-formed UTF-8 (surrogates allowed) at text[i]
inline char32_t decode(const uint8_t* text, int64_t n, int64_t i, int* len) {
  uint8_t c = text[i];
  int l = c < 0x80 ? 1 : c < 0xE0 ? 2 : c < 0xF0 ? 3 : 4;
  if (i + l > n) {  // a cut sequence: no word character
    *len = (int)(n - i);
    return 0xFFFD;
  }
  *len = l;
  switch (l) {
    case 1: return c;
    case 2: return ((char32_t)(c & 0x1F) << 6) | (text[i + 1] & 0x3F);
    case 3: return ((char32_t)(c & 0x0F) << 12) | ((char32_t)(text[i + 1] & 0x3F) << 6) | (text[i + 2] & 0x3F);
    default:
      return ((char32_t)(c & 0x07) << 18) | ((char32_t)(text[i + 1] & 0x3F) << 12) |
             ((char32_t)(text[i + 2] & 0x3F) << 6) | (text[i + 3] & 0x3F);
  }
}

}  // namespace

extern "C" {

// What one caller (one thread) owns: its output buffers of cap terms, the
// document length each call writes, and its State (tp_state_new). A caller
// never shares it with another thread, so calls are reentrant.
struct TpOut {
  uint32_t* ids;
  double* tfs;
  int64_t cap;
  int64_t doc_len;
  void* state;
};

void* tp_state_new() { return new State(); }

void tp_state_free(void* state) { delete static_cast<State*>(state); }

// Processes one text of n_bytes UTF-8 bytes. Writes the document length
// (kept non-stopword tokens) to out->doc_len. With want_terms, also finds
// each distinct term id in first-occurrence order and its BM25 tf
//   count * (k1 + 1) / (count + k1 * (1 - b + b * (doc_len / avg_doc_len)))
// and writes the first min(n, cap) of them to out->ids / out->tfs. Returns
// n, the number of distinct terms (0 without want_terms), or -1 where the
// Python expression would divide by zero.
int64_t tp_text_terms(TpOut* out, const uint8_t* text, int64_t n_bytes, int64_t max_token_len,
                      int32_t want_terms, double avg_doc_len, double k1, double b) {
  State& s = *static_cast<State*>(out->state);
  s.ids.clear();
  s.counts.clear();
  s.slots.clear();
  int64_t kept = 0;
  int64_t tok_start = -1;
  for (int64_t i = 0; i <= n_bytes;) {
    int len = 1;
    char32_t c = i < n_bytes ? decode(text, n_bytes, i, &len) : 0;
    if (i < n_bytes && is_word(c)) {
      if (tok_start < 0) {
        tok_start = i;
        s.tok.clear();
      }
      s.tok.push_back(c);
    } else if (tok_start >= 0) {
      if (i - tok_start <= max_token_len) {
        lower_token(s.tok, s.lowered);
        if (!is_stopword(s.lowered)) {
          kept++;
          if (want_terms) count_term(s, term_id(s));
        }
      }
      tok_start = -1;
    }
    i += len;
  }
  out->doc_len = kept;
  int64_t n = (int64_t)s.ids.size();
  if (n == 0) return 0;
  if (avg_doc_len == 0.0) return -1;
  double rel_len = (double)kept / avg_doc_len;
  for (int64_t t = 0; t < n; t++) {
    double count = (double)s.counts[t];
    double denom = count + k1 * (1.0 - b + b * rel_len);
    if (denom == 0.0) return -1;
    if (t < out->cap) {
      out->ids[t] = s.ids[t];
      out->tfs[t] = count * (k1 + 1.0) / denom;
    }
  }
  return n;
}

}  // extern "C"
