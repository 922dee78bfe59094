"""Caption metrics: BLEU-4, CIDEr, ROUGE-L, METEOR — pure Python.

The port's own copy of ``vlp3d/eval/capeval.py`` (pure Python).

Drop-in equivalents of the vendored pycocoevalcap-style scorers the
reference uses (`lib/capeval/{bleu,cider,rouge,meteor}`): same interface
(compute_score(gts, res) with dicts key -> list[str]) and EXACT value
parity with the vendored code (tests/test_refparity_capeval.py),
quirks included:

  * BLEU (bleu_scorer.py): 'closest' reference length; brevity penalty
    exp(1 - 1/ratio) with ratio = (testlen+1e-15)/(reflen+1e-9), applied
    per sample AND at the corpus level; case-sensitive whitespace split;
  * CIDEr (cider_scorer.py): RAW term frequency (no length
    normalization), idf = log(N) - log(max(1, df)), CLIPPED similarity
    min(h, r)*r, sigma = 6 gaussian length penalty on the (len-1) "bigram
    length" delta, x10 scaling;
  * ROUGE-L (rouge.py): beta = 1.2 F-measure of the INDEPENDENT maxima
    of precision and recall over references (not max-F); split(" ");
  * METEOR: a real METEOR 1.5 implementation (vlp3d_torch/eval/meteor.py):
    Snowball/Porter2 stemmer, beam alignment with fewest-chunks
    tie-break, 1.5 English parameters, micro-averaged corpus score.
    The reference shells out to meteor-1.5.jar
    (lib/capeval/meteor/meteor.py:12-24; the jar is not in the
    checkout). Synonym/paraphrase/function-word tables are jar data
    assets — supported behind optional paths, absent by default, which
    is the only residual deviation from the jar.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _all_ngrams(tokens, n):
    """Counts of every ngram order 1..n in one dict (precook,
    cider_scorer.py:11-26)."""
    counts = Counter()
    for k in range(1, n + 1):
        for i in range(len(tokens) - k + 1):
            counts[tuple(tokens[i : i + k])] += 1
    return counts


# --------------------------------------------------------------- BLEU
class Bleu:
    """Corpus BLEU, value-exact vs lib/capeval/bleu (option='closest')."""

    def __init__(self, n: int = 4):
        self.n = n

    def compute_score(self, gts: dict, res: dict):
        small = 1e-9
        tiny = 1e-15
        tot_correct = [0.0] * self.n
        tot_guess = [0.0] * self.n
        tot_testlen = 0
        tot_reflen = 0.0
        per_sample = [[] for _ in range(self.n)]

        for key in gts:
            hyp = res[key][0].split()
            refs = [r.split() for r in gts[key]]
            testlen = len(hyp)
            reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
            tot_testlen += testlen
            tot_reflen += reflen

            bleu = 1.0
            for k in range(self.n):
                nn = k + 1
                h = _ngrams(hyp, nn)
                max_ref = Counter()
                for r in refs:
                    for gram, cnt in _ngrams(r, nn).items():
                        max_ref[gram] = max(max_ref[gram], cnt)
                correct = sum(min(cnt, max_ref[g]) for g, cnt in h.items())
                guess = max(testlen - k, 0)
                tot_correct[k] += correct
                tot_guess[k] += guess
                bleu *= (correct + tiny) / (guess + small)
                per_sample[k].append(bleu ** (1.0 / nn))
            # per-sample brevity penalty (bleu_scorer.py:236-239)
            ratio = (testlen + tiny) / (reflen + small)
            if ratio < 1:
                for k in range(self.n):
                    per_sample[k][-1] *= math.exp(1 - 1 / ratio)

        scores = []
        bleu = 1.0
        for k in range(self.n):
            bleu *= (tot_correct[k] + tiny) / (tot_guess[k] + small)
            scores.append(bleu ** (1.0 / (k + 1)))
        ratio = (tot_testlen + tiny) / (tot_reflen + small)
        if ratio < 1:
            for k in range(self.n):
                scores[k] *= math.exp(1 - 1 / ratio)
        return scores, per_sample

    def score(self, gts, res):
        return self.compute_score(gts, res)


# --------------------------------------------------------------- CIDEr
class Cider:
    """Value-exact vs lib/capeval/cider: raw-tf tf-idf vectors, clipped
    min(h,r)*r similarity, per-order cosine averaged then /nrefs x10."""

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: dict, res: dict):
        crefs = {
            key: [_all_ngrams(r.split(), self.n) for r in gts[key]]
            for key in gts
        }
        df = defaultdict(float)
        for key in gts:
            for g in set(g for cnt in crefs[key] for g in cnt):
                df[g] += 1.0
        ref_len = math.log(float(len(gts)))

        def counts2vec(cnts):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for g, tf in cnts.items():
                n = len(g) - 1
                vec[n][g] = float(tf) * (ref_len - math.log(max(1.0, df[g])))
                norm[n] += vec[n][g] ** 2
                if n == 1:  # the reference's "length" counts bigrams
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        scores = []
        for key in gts:
            vec, norm, length = counts2vec(
                _all_ngrams(res[key][0].split(), self.n)
            )
            score = 0.0
            for rc in crefs[key]:
                vr, nr, lr = counts2vec(rc)
                mult = math.exp(
                    -(float(length - lr) ** 2) / (2 * self.sigma**2)
                )
                for n in range(self.n):
                    val = sum(
                        min(vec[n][g], vr[n][g]) * vr[n][g] for g in vec[n]
                    )
                    if norm[n] != 0 and nr[n] != 0:
                        val /= norm[n] * nr[n]
                    score += val * mult
            scores.append(10.0 * score / self.n / len(gts[key]))
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores

    def score(self, gts, res):
        return self.compute_score(gts, res)


# --------------------------------------------------------------- ROUGE-L
def _lcs_len(a, b):
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


class Rouge:
    """Value-exact vs lib/capeval/rouge: F(beta=1.2) of the independent
    per-reference maxima of precision and recall (rouge.py:44-75)."""

    beta = 1.2

    def compute_score(self, gts: dict, res: dict):
        scores = []
        for key in gts:
            hyp = res[key][0].split(" ")
            prec, rec = [], []
            for r in gts[key]:
                ref = r.split(" ")
                lcs = _lcs_len(hyp, ref)
                prec.append(lcs / float(len(hyp)))
                rec.append(lcs / float(len(ref)))
            prec_max, rec_max = max(prec), max(rec)
            if prec_max != 0 and rec_max != 0:
                f = (
                    (1 + self.beta**2)
                    * prec_max
                    * rec_max
                    / float(rec_max + self.beta**2 * prec_max)
                )
            else:
                f = 0.0
            scores.append(f)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores

    def score(self, gts, res):
        return self.compute_score(gts, res)


# --------------------------------------------------------------- METEOR
# Real METEOR 1.5 implementation (Snowball stemmer, beam aligner, the
# 1.5 English parameters) — see vlp3d_torch/eval/meteor.py. Replaces the
# jar subprocess the reference uses (lib/capeval/meteor/meteor.py:12-24).
from vlp3d_torch.eval.meteor import Meteor15 as Meteor  # noqa: E402

__all__ = ["Bleu", "Cider", "Rouge", "Meteor"]
