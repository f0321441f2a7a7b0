"""Symbol inventory (reference: `text/symbols.py` — pad + punctuation +
letters + ARPAbet phones with '@' prefix).

The port's own copy of `amphion_tpu/text/symbols.py`.
"""

from __future__ import annotations

_PAD = "_"
_PUNC = "!'(),.:;? "
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"

ARPABET = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1",
    "AH2", "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0",
    "AY1", "AY2", "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0",
    "ER1", "ER2", "EY", "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0",
    "IH1", "IH2", "IY", "IY0", "IY1", "IY2", "JH", "K", "L", "M", "N", "NG",
    "OW", "OW0", "OW1", "OW2", "OY", "OY0", "OY1", "OY2", "P", "R", "S", "SH",
    "T", "TH", "UH", "UH0", "UH1", "UH2", "UW", "UW0", "UW1", "UW2", "V", "W",
    "Y", "Z", "ZH",
]

SYMBOLS = [_PAD] + list(_PUNC) + list(_LETTERS) + ["@" + p for p in ARPABET]

_SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}
_ID_TO_SYMBOL = {i: s for i, s in enumerate(SYMBOLS)}


def symbols_to_ids(symbols: list[str]) -> list[int]:
    return [_SYMBOL_TO_ID[s] for s in symbols if s in _SYMBOL_TO_ID]


def ids_to_symbols(ids: list[int]) -> list[str]:
    return [_ID_TO_SYMBOL[i] for i in ids]
