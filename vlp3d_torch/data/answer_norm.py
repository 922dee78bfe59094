"""VQA answer normalization (the standard VQA-eval convention).

The port's own copy of ``vlp3d/data/answer_norm.py`` (the reference's
``lib/vqa/qa_helper.py:8-133``, itself the MCAN-VQA copy of the official
VQA evaluation normalization): strip punctuation with the
comma-in-number and period-not-in-number exceptions, drop articles, map
number words to digits, and restore apostrophes in contractions. Used to
canonicalize free-form answers before building the answer vocabulary.

The contraction and number-word tables are the standard VQA-eval data
tables, reproduced as data (they are a published convention, not code).
"""

from __future__ import annotations

import collections
import re

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}

_NUMBER_WORDS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}

_ARTICLES = frozenset({"a", "an", "the"})
# period not part of a number; comma inside a number (qa_helper.py:67-68)
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_IN_NUMBER = re.compile(r"(\d)(,)(\d)")
_PUNCT = (
    ";", "/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_",
    "-", ">", "<", "@", "`", ",", "?", "!",
)


def process_punctuation(text: str) -> str:
    out = text
    for ch in _PUNCT:
        # drop the char entirely when it borders a space or the string
        # contains a digit-grouping comma; otherwise replace with a space
        if (ch + " " in text or " " + ch in text) or _COMMA_IN_NUMBER.search(
            text
        ):
            out = out.replace(ch, "")
        else:
            out = out.replace(ch, " ")
    return _PERIOD_STRIP.sub("", out)


def process_digit_article(text: str) -> str:
    words = []
    for word in text.lower().split():
        word = _NUMBER_WORDS.get(word, word)
        if word not in _ARTICLES:
            words.append(word)
    return " ".join(
        _CONTRACTIONS.get(word, word) for word in words
    )


def prep_ans(answer: str) -> str:
    """Canonical answer form (qa_helper.py:102-105)."""
    return process_digit_article(process_punctuation(answer)).replace(
        ",", ""
    )


def normalize_answer_counter(
    counter: collections.Counter,
) -> collections.Counter:
    """Merge counts of answers that normalize to the same form, dropping
    empties (qa_helper.py:108-117)."""
    out: collections.Counter = collections.Counter()
    for answer, count in counter.items():
        norm = prep_ans(answer)
        if not answer or not norm:
            continue
        out[norm] += count
    return out


def normalize_answers_in_qa_data(records: list[dict]) -> list[dict]:
    """Normalize every record's answers in place, dropping records whose
    answers all normalize away (qa_helper.py:120-133)."""
    kept = []
    for record in records:
        norm = [prep_ans(a) for a in record["answers"]]
        norm = [a for a in norm if a]
        if not norm:
            continue
        record["answers"] = norm
        kept.append(record)
    return kept
