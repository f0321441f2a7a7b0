"""Text cleaners (reference: `text/cleaners.py`, `text/numbers.py`).

Native implementations: abbreviation expansion, number verbalization (no
num2words/inflect dependency), whitespace collapse, lowercasing, ASCII
transliteration.

The port's own copy of `amphion_tpu/text/cleaners.py` (pure `re` and
`unicodedata`).
"""

from __future__ import annotations

import re
import unicodedata

_ABBREVIATIONS = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), repl)
    for abbr, repl in [
        ("mrs", "misess"), ("mr", "mister"), ("dr", "doctor"), ("st", "saint"),
        ("co", "company"), ("jr", "junior"), ("maj", "major"), ("gen", "general"),
        ("drs", "doctors"), ("rev", "reverend"), ("lt", "lieutenant"),
        ("hon", "honorable"), ("sgt", "sergeant"), ("capt", "captain"),
        ("esq", "esquire"), ("ltd", "limited"), ("col", "colonel"), ("ft", "fort"),
    ]
]

_ONES = ["", "one", "two", "three", "four", "five", "six", "seven", "eight",
         "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
         "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]
_SCALES = [(10**9, "billion"), (10**6, "million"), (10**3, "thousand"),
           (10**2, "hundred")]


def number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n] if n > 0 else "zero"
    if n < 100:
        t, o = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    for scale, name in _SCALES:
        if n >= scale:
            big, rest = divmod(n, scale)
            out = number_to_words(big) + " " + name
            if rest:
                out += " " + number_to_words(rest)
            return out
    return str(n)


def _expand_number(m: re.Match) -> str:
    num = m.group(0).replace(",", "")
    if "." in num:
        whole, frac = num.split(".")
        out = number_to_words(int(whole)) if whole else "zero"
        out += " point " + " ".join(number_to_words(int(d)) for d in frac)
        return out
    n = int(num)
    # years like 1984 → nineteen eighty four
    if 1000 < n < 3000 and len(num) == 4 and num[2] != "0":
        return number_to_words(int(num[:2])) + " " + number_to_words(int(num[2:]))
    return number_to_words(n)


def _expand_currency(m: re.Match) -> str:
    amount = m.group(1).replace(",", "")
    if "." in amount:
        d, c = amount.split(".")
        out = number_to_words(int(d or 0)) + " dollars"
        if int(c or 0):
            out += " " + number_to_words(int(c)) + " cents"
        return out
    return number_to_words(int(amount)) + " dollars"


def normalize_numbers(text: str) -> str:
    text = re.sub(r"\$([0-9][0-9,]*(?:\.[0-9]+)?)", _expand_currency, text)
    text = re.sub(r"([0-9]+)%", lambda m: _expand_number(m) + " percent", text)
    text = re.sub(r"[0-9][0-9,]*(?:\.[0-9]+)?", _expand_number, text)
    return text


def expand_abbreviations(text: str) -> str:
    for pattern, repl in _ABBREVIATIONS:
        text = pattern.sub(repl, text)
    return text


def collapse_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def transliterate(text: str) -> str:
    """Unicode → closest ASCII (unidecode-lite)."""
    return (
        unicodedata.normalize("NFKD", text).encode("ascii", "ignore").decode("ascii")
    )


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(text.lower())


def english_cleaners(text: str) -> str:
    text = transliterate(text)
    text = text.lower()
    text = normalize_numbers(text)
    text = expand_abbreviations(text)
    return collapse_whitespace(text)
