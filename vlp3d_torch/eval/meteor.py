"""METEOR 1.5 scorer, implemented from the algorithm (no Java subprocess).

The port's own copy of ``vlp3d/eval/meteor.py`` (pure Python).

The reference scores METEOR by piping through `java -jar meteor-1.5.jar
- - -stdio -l en -norm` (lib/capeval/meteor/meteor.py:12-24; the jar is a
git-ignored asset). This module re-implements the METEOR 1.5 algorithm
(Denkowski & Lavie 2014, "Meteor Universal") natively:

  * matchers: exact and stem (Snowball English / Porter2 stemmer, the
    stemmer meteor-1.5 uses) always; synonym and paraphrase matchers are
    supported behind optional asset paths (their tables — WordNet synsets
    and paraphrase-en.gz — are data assets of the jar, not algorithm).
  * alignment: beam search over one-to-one matches maximizing matched
    words, tie-broken by fewest chunks, then highest matcher weight, then
    smallest total match distance (the jar's resolution order).
  * scoring: the 1.5 English task parameters alpha=0.85, beta=0.2,
    gamma=0.6, delta=0.75 with matcher weights exact=1.0, stem=0.6,
    synonym=0.8, paraphrase=0.6; content/function word discounting via
    delta (inert when no function-word list is supplied: the list is a
    jar resource); fragmentation penalty gamma*(chunks/avg_matches)^beta;
    segment score = fmean*(1-penalty); multi-reference = best-scoring
    reference; corpus score = micro-average over summed statistics
    (exactly what the jar's final EVAL line prints).

Documented residual deviation from the jar: without the synonym/
paraphrase/function-word assets, matches those stages would add are
missed and delta-discounting is inert — scores are a (typically tight)
lower bound of the jar's. Point the optional paths at the extracted jar
resources to close the gap.
"""

from __future__ import annotations

import gzip
import math
import re
from dataclasses import dataclass, field

__all__ = ["stem", "Meteor15", "meteor_normalize"]


# ---------------------------------------------------------------------------
# Snowball English ("Porter2") stemmer — the stemmer meteor-1.5 uses
# (org.tartarus.snowball.ext.englishStemmer). Implemented from the
# published Snowball English algorithm with the region-suffix update
# discipline of the canonical implementations (R1/R2 tracked as suffix
# strings mutated in lockstep with the word, including the boundary
# quirks when a replacement spans a region edge). Oracle-tested
# word-for-word against nltk's pure-Python SnowballStemmer("english")
# in tests/test_meteor.py.
# ---------------------------------------------------------------------------

_VOWELS = "aeiouy"
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDINGS = "cdeghkmnrt"

_SPECIAL = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie",
    "tying": "tie", "idly": "idl", "gently": "gentl", "ugly": "ugli",
    "early": "earli", "only": "onli", "singly": "singl",
    # invariant forms
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
    # -eed / -ing forms that must not be touched (exception list 2)
    "inning": "inning", "innings": "inning",
    "outing": "outing", "outings": "outing",
    "canning": "canning", "cannings": "canning",
    "herring": "herring", "herrings": "herring",
    "earring": "earring", "earrings": "earring",
    "proceed": "proceed", "proceeds": "proceed",
    "proceeded": "proceed", "proceeding": "proceed",
    "exceed": "exceed", "exceeds": "exceed",
    "exceeded": "exceed", "exceeding": "exceed",
    "succeed": "succeed", "succeeds": "succeed",
    "succeeded": "succeed", "succeeding": "succeed",
}

# step 2/3 tables: suffix -> op, where op is
#   ("t", n)         truncate the last n chars (regions keep their tails)
#   ("r", rep, fb)   replace the whole suffix; a region shorter than the
#                    suffix collapses to fb (canonical boundary quirk)
#   ("e",)           swap the final char for "e" (enci/anci/abli)
_STEP2 = (
    ("ization", ("r", "ize", "")), ("ational", ("r", "ate", "e")),
    ("fulness", ("t", 4)), ("ousness", ("r", "ous", "")),
    ("iveness", ("r", "ive", "e")), ("tional", ("t", 2)),
    ("biliti", ("r", "ble", "")), ("lessli", ("t", 2)),
    ("entli", ("t", 2)), ("ation", ("r", "ate", "e")),
    ("alism", ("r", "al", "")), ("aliti", ("r", "al", "")),
    ("ousli", ("r", "ous", "")), ("iviti", ("r", "ive", "e")),
    ("fulli", ("t", 2)), ("enci", ("e",)), ("anci", ("e",)),
    ("abli", ("e",)), ("izer", ("r", "ize", "")),
    ("ator", ("r", "ate", "e")), ("alli", ("r", "al", "")),
    ("bli", ("r", "ble", "")),
)

_STEP3 = (
    ("ational", ("r", "ate", "")), ("tional", ("t", 2)),
    ("alize", ("t", 3)), ("icate", ("r", "ic", "")),
    ("iciti", ("r", "ic", "")), ("ical", ("r", "ic", "")),
    ("ness", ("t", 4)), ("ful", ("t", 3)),
)

_STEP4 = (
    "ement", "ance", "ence", "able", "ible", "ment",
    "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize", "ion",
    "al", "er", "ic",
)


def _apply(word: str, r1: str, r2: str, suffix: str, op: tuple):
    if op[0] == "t":
        return _trunc(word, r1, r2, op[1])
    if op[0] == "e":
        word = word[:-1] + "e"
        r1 = r1[:-1] + "e" if r1 else ""
        r2 = r2[:-1] + "e" if r2 else ""
        return word, r1, r2
    return _replace(word, r1, r2, suffix, op[1], op[2])


def _has_vowel(segment: str) -> bool:
    return any(ch in _VOWELS for ch in segment)


def _trunc(word: str, r1: str, r2: str, n: int):
    """Drop the last n chars from word and regions in lockstep."""
    return word[:-n], r1[:-n], r2[:-n]


def _replace(word: str, r1: str, r2: str, suffix: str, rep: str,
             r2_fallback: str = ""):
    """Replace a word-final suffix, mutating the region suffixes in
    lockstep; a region shorter than the suffix collapses to its
    fallback (the canonical boundary behavior)."""
    n = len(suffix)
    word = word[:-n] + rep
    r1 = r1[:-n] + rep if len(r1) >= n else ""
    r2 = r2[:-n] + rep if len(r2) >= n else r2_fallback
    return word, r1, r2


def _regions(word: str) -> tuple[str, str]:
    """R1/R2 as suffix strings, with the gener/commun/arsen prefix rule."""
    if word.startswith(("gener", "commun", "arsen")):
        r1 = word[6:] if word.startswith("commun") else word[5:]
    else:
        r1 = ""
        for i in range(1, len(word)):
            if word[i] not in _VOWELS and word[i - 1] in _VOWELS:
                r1 = word[i + 1:]
                break
    r2 = ""
    for i in range(1, len(r1)):
        if r1[i] not in _VOWELS and r1[i - 1] in _VOWELS:
            r2 = r1[i + 1:]
            break
    return r1, r2


def stem(word: str) -> str:
    """Snowball English (Porter2) stem of a word."""
    word = word.lower()
    if len(word) <= 2:
        return word
    if word in _SPECIAL:
        return _SPECIAL[word]

    for apo in ("\u2019", "\u2018", "\u201b"):
        word = word.replace(apo, "'")
    if word.startswith("'"):
        word = word[1:]

    # mark consonant y's (initial y, or y after a vowel) as Y
    if word.startswith("y"):
        word = "Y" + word[1:]
    for i in range(1, len(word)):
        if word[i] == "y" and word[i - 1] in _VOWELS:
            word = word[:i] + "Y" + word[i + 1:]

    r1, r2 = _regions(word)

    # step 0: apostrophe suffixes
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word, r1, r2 = _trunc(word, r1, r2, len(suf))
            break

    # step 1a
    if word.endswith("sses"):
        word, r1, r2 = _trunc(word, r1, r2, 2)
    elif word.endswith(("ied", "ies")):
        n = 2 if len(word) > 4 else 1
        word, r1, r2 = _trunc(word, r1, r2, n)
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s") and _has_vowel(word[:-2]):
        word, r1, r2 = _trunc(word, r1, r2, 1)

    # step 1b
    if word.endswith(("eedly", "eed")):
        suf = "eedly" if word.endswith("eedly") else "eed"
        if r1.endswith(suf):
            word, r1, r2 = _replace(word, r1, r2, suf, "ee")
    else:
        for suf in ("ingly", "edly", "ing", "ed"):
            if word.endswith(suf):
                if _has_vowel(word[: -len(suf)]):
                    word, r1, r2 = _trunc(word, r1, r2, len(suf))
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                        r1 += "e"
                        if len(word) > 5 or len(r1) >= 3:
                            r2 += "e"
                    elif word.endswith(_DOUBLES):
                        word, r1, r2 = _trunc(word, r1, r2, 1)
                    elif r1 == "" and _ends_short_syllable(word):
                        word += "e"
                break

    # step 1c: y -> i after a non-vowel that isn't the first letter
    if len(word) > 2 and word[-1] in "yY" and word[-2] not in _VOWELS:
        word = word[:-1] + "i"
        r1 = r1[:-1] + "i" if r1 else ""
        r2 = r2[:-1] + "i" if r2 else ""

    # step 2 (longest suffix; applies only when it lies inside R1)
    for suf, op in _STEP2:
        if word.endswith(suf):
            if r1.endswith(suf):
                word, r1, r2 = _apply(word, r1, r2, suf, op)
            break
    else:
        if word.endswith("ogi"):
            if r1.endswith("ogi") and word[-4] == "l":
                word, r1, r2 = _trunc(word, r1, r2, 1)
        elif word.endswith("li"):
            if r1.endswith("li") and word[-3] in _LI_ENDINGS:
                word, r1, r2 = _trunc(word, r1, r2, 2)

    # step 3 (in R1; "ative" additionally requires R2)
    for suf, op in _STEP3:
        if word.endswith(suf):
            if r1.endswith(suf):
                word, r1, r2 = _apply(word, r1, r2, suf, op)
            break
    else:
        if word.endswith("ative") and r1.endswith("ative"):
            if r2.endswith("ative"):
                word, r1, r2 = _trunc(word, r1, r2, 5)

    # step 4 (in R2; "ion" only after s/t)
    for suf in _STEP4:
        if word.endswith(suf):
            if r2.endswith(suf):
                if suf == "ion":
                    if word[-4] in "st":
                        word, r1, r2 = _trunc(word, r1, r2, 3)
                else:
                    word, r1, r2 = _trunc(word, r1, r2, len(suf))
            break

    # step 5
    if r2.endswith("l") and word[-2] == "l":
        word = word[:-1]
    elif r2.endswith("e"):
        word = word[:-1]
    elif r1.endswith("e"):
        if len(word) >= 4 and (
            word[-2] in _VOWELS
            or word[-2] in "wxY"
            or word[-3] not in _VOWELS
            or word[-4] in _VOWELS
        ):
            word = word[:-1]

    return word.replace("Y", "y")


def _ends_short_syllable(word: str) -> bool:
    """Short syllable: non-vowel + vowel + non-vowel(not w,x,Y) at the
    end, or vowel + non-vowel making up the whole 2-letter word."""
    if len(word) == 2:
        return word[0] in _VOWELS and word[1] not in _VOWELS
    if len(word) >= 3:
        a, b, c = word[-3], word[-2], word[-1]
        return a not in _VOWELS and b in _VOWELS and c not in _VOWELS + "wxY"
    return False



# ---------------------------------------------------------------------------
# -norm style normalization (lowercase + punctuation tokenization)
# ---------------------------------------------------------------------------

_UNICODE_MAP = {
    "‘": "'", "’": "'", "“": '"', "”": '"',
    "–": "-", "—": "-", " ": " ",
}
_PUNCT_RE = re.compile(r"([^\w\s'-])")


def meteor_normalize(text: str) -> list[str]:
    """Lowercase, map unicode punctuation to ASCII, split punctuation
    into separate tokens (the jar's `-norm` behavior on pre-tokenized
    caption text)."""
    for src, dst in _UNICODE_MAP.items():
        text = text.replace(src, dst)
    text = _PUNCT_RE.sub(r" \1 ", text)
    return text.lower().split()


# ---------------------------------------------------------------------------
# Aligner + scorer
# ---------------------------------------------------------------------------

# METEOR 1.5 English task parameters (Meteor Universal, Table 2) as used
# by `-l en -norm` with no -t override.
ALPHA = 0.85
BETA = 0.2
GAMMA = 0.6
DELTA = 0.75
# matcher weights: exact, stem, synonym, paraphrase
WEIGHTS = (1.0, 0.6, 0.8, 0.6)

_BEAM = 64


@dataclass
class _Stats:
    """Per-segment METEOR sufficient statistics (MeteorStats)."""

    hyp_len_content: float = 0.0
    hyp_len_function: float = 0.0
    ref_len_content: float = 0.0
    ref_len_function: float = 0.0
    hyp_weighted: float = 0.0  # sum_i w_i * (d*m_c + (1-d)*m_f) over hyp
    ref_weighted: float = 0.0
    hyp_matches: int = 0  # unweighted matched hyp words
    ref_matches: int = 0
    chunks: int = 0

    def add(self, other: "_Stats") -> None:
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(other, f))

    def score(self) -> float:
        hyp_len = DELTA * self.hyp_len_content + (1 - DELTA) * self.hyp_len_function
        ref_len = DELTA * self.ref_len_content + (1 - DELTA) * self.ref_len_function
        if self.hyp_matches == 0 or self.ref_matches == 0:
            return 0.0
        if hyp_len == 0 or ref_len == 0:
            return 0.0
        p = self.hyp_weighted / hyp_len
        r = self.ref_weighted / ref_len
        if p == 0.0 or r == 0.0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1 - ALPHA) * r)
        frag = self.chunks / ((self.hyp_matches + self.ref_matches) / 2.0)
        penalty = GAMMA * math.pow(frag, BETA)
        return fmean * (1.0 - penalty)


@dataclass
class _Beam:
    used_ref: frozenset
    matches: tuple = ()  # ((hi, ri, stage), ...) in hyp order
    n: int = 0
    chunks: int = 0
    weight: float = 0.0
    dist: int = 0

    def key(self):
        return (-self.n, self.chunks, -self.weight, self.dist)


class Meteor15:
    """Drop-in replacement for the reference's jar wrapper: same
    `compute_score(gts, res) -> (corpus_score, per_segment_scores)`.

    Optional assets (all plain text, derived from the jar's resources):
      synonyms_path    — lines of whitespace-separated words forming one
                         synonym set each
      paraphrases_path — lines `phrase ||| phrase` (gz accepted)
      function_words_path — one function word per line
    """

    def __init__(
        self,
        synonyms_path: str | None = None,
        paraphrases_path: str | None = None,
        function_words_path: str | None = None,
    ):
        self.syn_groups: dict[str, set[int]] = {}
        if synonyms_path:
            with open(synonyms_path, encoding="utf-8") as f:
                for gid, line in enumerate(f):
                    for w in line.split():
                        self.syn_groups.setdefault(w.lower(), set()).add(gid)
        self.paraphrases: dict[tuple, set[tuple]] = {}
        if paraphrases_path:
            opener = gzip.open if paraphrases_path.endswith(".gz") else open
            with opener(paraphrases_path, "rt", encoding="utf-8") as f:
                for line in f:
                    parts = [p.strip() for p in line.split("|||")]
                    if len(parts) < 2:
                        continue
                    a = tuple(parts[0].lower().split())
                    b = tuple(parts[1].lower().split())
                    if a and b:
                        self.paraphrases.setdefault(a, set()).add(b)
                        self.paraphrases.setdefault(b, set()).add(a)
        self.function_words: set[str] = set()
        if function_words_path:
            with open(function_words_path, encoding="utf-8") as f:
                self.function_words = {w.strip().lower() for w in f if w.strip()}

    # -- matching ----------------------------------------------------------

    def _word_match_stage(self, h: str, r: str,
                          h_stem: str, r_stem: str) -> int | None:
        if h == r:
            return 0
        if h_stem == r_stem:
            return 1
        if self.syn_groups:
            if self.syn_groups.get(h, set()) & self.syn_groups.get(r, set()):
                return 2
        return None

    def _align(self, hyp: list[str], ref: list[str]) -> list[tuple]:
        """One-to-one word alignment: beam search maximizing matched
        words, then fewest chunks, then highest matcher weight, then
        smallest total |i-j| distance. Returns [(hi, ri, stage), ...]."""
        h_stems = [stem(w) for w in hyp]
        r_stems = [stem(w) for w in ref]
        candidates: list[list[tuple[int, int]]] = []
        for i, h in enumerate(hyp):
            cands = []
            for j, r in enumerate(ref):
                s = self._word_match_stage(h, r, h_stems[i], r_stems[j])
                if s is not None:
                    cands.append((j, s))
            candidates.append(cands)

        beams = [_Beam(used_ref=frozenset())]
        for i in range(len(hyp)):
            nxt: list[_Beam] = []
            for b in beams:
                nxt.append(b)  # leave hyp word i unmatched
                for j, s in candidates[i]:
                    if j in b.used_ref:
                        continue
                    if b.matches:
                        li, lj, _ = b.matches[-1]
                        contiguous = (i == li + 1) and (j == lj + 1)
                    else:
                        contiguous = False
                    nxt.append(_Beam(
                        used_ref=b.used_ref | {j},
                        matches=b.matches + ((i, j, s),),
                        n=b.n + 1,
                        chunks=b.chunks + (0 if contiguous else 1),
                        weight=b.weight + WEIGHTS[s],
                        dist=b.dist + abs(i - j),
                    ))
            nxt.sort(key=_Beam.key)
            # dedup identical used-ref sets keeping the best
            seen: set = set()
            beams = []
            for b in nxt:
                k = (b.used_ref, b.matches[-1] if b.matches else None)
                if k in seen:
                    continue
                seen.add(k)
                beams.append(b)
                if len(beams) >= _BEAM:
                    break
        best = min(beams, key=_Beam.key)
        matches = list(best.matches)

        # paraphrase stage on the remaining unmatched spans (phrase level)
        if self.paraphrases:
            matches = self._add_paraphrase_matches(hyp, ref, matches)
        return matches

    def _add_paraphrase_matches(self, hyp, ref, matches):
        used_h = {m[0] for m in matches}
        used_r = {m[1] for m in matches}
        max_len = max((len(k) for k in self.paraphrases), default=1)
        for i in range(len(hyp)):
            for li in range(min(max_len, len(hyp) - i), 0, -1):
                if any(x in used_h for x in range(i, i + li)):
                    continue
                hp = tuple(hyp[i:i + li])
                targets = self.paraphrases.get(hp)
                if not targets:
                    continue
                placed = False
                for j in range(len(ref)):
                    for lj in range(min(max_len, len(ref) - j), 0, -1):
                        if any(x in used_r for x in range(j, j + lj)):
                            continue
                        if tuple(ref[j:j + lj]) in targets:
                            # record word-level links for chunk counting:
                            # pair up positions pointwise (min span)
                            span = min(li, lj)
                            for t in range(span):
                                matches.append((i + t, j + t, 3))
                            used_h.update(range(i, i + li))
                            used_r.update(range(j, j + lj))
                            placed = True
                            break
                    if placed:
                        break
                if placed:
                    break
        return sorted(matches)

    # -- scoring -----------------------------------------------------------

    def _segment_stats(self, hyp: list[str], ref: list[str]) -> _Stats:
        st = _Stats()
        is_f = lambda w: w in self.function_words  # noqa: E731
        for w in hyp:
            if is_f(w):
                st.hyp_len_function += 1
            else:
                st.hyp_len_content += 1
        for w in ref:
            if is_f(w):
                st.ref_len_function += 1
            else:
                st.ref_len_content += 1
        matches = self._align(hyp, ref)
        st.hyp_matches = len(matches)
        st.ref_matches = len(matches)
        # chunks over the final alignment, in hyp order
        last = None
        for (i, j, s) in matches:
            if last is None or i != last[0] + 1 or j != last[1] + 1:
                st.chunks += 1
            last = (i, j)
            w = WEIGHTS[s]
            st.hyp_weighted += w * (DELTA if not is_f(hyp[i]) else 1 - DELTA)
            st.ref_weighted += w * (DELTA if not is_f(ref[j]) else 1 - DELTA)
        return st

    def score_segment(self, hypothesis: str, references: list[str]) -> float:
        return self._best_stats(hypothesis, references).score()

    def _best_stats(self, hypothesis: str, references: list[str]) -> _Stats:
        hyp = meteor_normalize(hypothesis)
        best: _Stats | None = None
        for r in references:
            st = self._segment_stats(hyp, meteor_normalize(r))
            if best is None or st.score() > best.score():
                best = st
        return best if best is not None else _Stats()

    def compute_score(self, gts: dict, res: dict):
        total = _Stats()
        scores = []
        for key in gts:
            st = self._best_stats(res[key][0], gts[key])
            scores.append(st.score())
            total.add(st)
        return total.score(), scores

    def score(self, gts, res):
        return self.compute_score(gts, res)

    def method(self):
        return "METEOR"
